"""Profile the e2e FASTQ->BAM workflow on the GPU to find host hotspots.

Run: python profile_e2e.py [--paired]
"""
import cProfile
import pstats
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
from bench import make_genome, make_reads, READ_LEN, GENOME_LEN  # noqa: E402
from isaac_aligner_tpu import dna  # noqa: E402
from isaac_aligner_tpu.index.build import build_index  # noqa: E402
from isaac_aligner_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from isaac_aligner_tpu.utils.device import require_gpu  # noqa: E402
from isaac_aligner_tpu.workflow.align import AlignWorkflow, WorkflowOptions  # noqa: E402


def main():
    enable_compile_cache()
    require_gpu()
    N_READS = 131_072
    BATCH = 32_768
    PAIRED = "--paired" in sys.argv

    rng = np.random.default_rng(0)
    genome = make_genome(rng)
    index = build_index(genome, seed_len=32)

    td = Path(tempfile.mkdtemp(prefix="isaac_prof_"))
    index.save(td / "idx")
    er, _ = make_reads(genome.codes, rng, N_READS)
    qs = "?" * READ_LEN
    print("writing fastq", file=sys.stderr)
    with open(td / "r1.fq", "w") as f:
        f.writelines(f"@r{i}\n{dna.decode(er[i])}\n+\n{qs}\n" for i in range(N_READS))
    fq2 = None
    if PAIRED:
        starts = rng.integers(0, GENOME_LEN - 500, N_READS)
        e2 = genome.codes[(starts + 300 - READ_LEN)[:, None] + np.arange(READ_LEN)[None, :]]
        e2 = np.where(e2[:, ::-1] < 4, 3 - e2[:, ::-1], e2[:, ::-1]).astype(np.uint8)
        with open(td / "r2.fq", "w") as f:
            f.writelines(f"@r{i}\n{dna.decode(e2[i])}\n+\n{qs}\n" for i in range(N_READS))
        fq2 = str(td / "r2.fq")


    def run(name):
        wf = AlignWorkflow(WorkflowOptions(
            reference=str(td / "idx"), output_dir=str(td / name),
            fastq1=str(td / "r1.fq"), fastq2=fq2, batch_size=BATCH,
            realign_gaps="no", records_per_bin=2_000_000))
        t0 = time.time()
        wf.run()
        return time.time() - t0


    print("warmup (compile)", file=sys.stderr)
    w = run("warm")
    print(f"warm: {w:.1f}s", file=sys.stderr)

    pr = cProfile.Profile()
    pr.enable()
    t = run("timed")
    pr.disable()
    print(f"timed: {t:.1f}s = {N_READS/t:.0f} reads/s", file=sys.stderr)
    st = pstats.Stats(pr)
    st.sort_stats("cumulative").print_stats(45)
    st.sort_stats("tottime").print_stats(35)


if __name__ == "__main__":
    main()
