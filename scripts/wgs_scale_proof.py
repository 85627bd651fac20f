"""Whole-human-genome-scale proof (BASELINE config 4->5 rung): build a GRCh38-scale synthetic genome, sort-reference
it into contig-group indexes (streaming, bounded RAM), and run a paired
FASTQ -> sorted-BAM e2e through the group-major multi-index path on the
accelerator.

Usage: python scripts/wgs_scale_proof.py [--mbp N] [--skip-align]
Defaults to 3100 Mbp (GRCh38 scale).  Reference baselines: the human
index build takes ~11 h / ~150 GB RAM on a 24-thread node
(/root/reference/src/markdown/manual.md:634-643).

Device-memory strategy: each contig group's planes are ~6.5 GB (450 Mbp
padded to 512 M records x 13 B).  When all groups together exceed the
device's plane budget (workflow/align.py device_plane_budget) the
workflow selects GROUP-MAJOR residency (parallel/multi_index.py): upload
group g once, stream every batch through it, free, next group.  Upload
cost is once per run and amortizes over run size; the script reports it
separately from the post-upload align rate.
"""
import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from isaac_aligner_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def main():
    # NOTE: everything lives under a main() guard — the workflow's
    # output SUBPROCESS re-imports __main__ (multiprocessing spawn);
    # an unguarded script re-executes itself in the child
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=3100.0)
    ap.add_argument("--pairs", type=int, default=131_072)
    ap.add_argument("--work", default=str(
        Path(__file__).resolve().parent.parent / "work" / "wgs"))
    ap.add_argument("--skip-align", action="store_true")
    ap.add_argument("--skip-build", action="store_true",
                    help="reuse an existing index in --work")
    args = ap.parse_args()
    enable_compile_cache()

    N = int(args.mbp * 1e6)
    CONTIG = 390_000_000          # chromosome-scale contigs
    GROUP_LIMIT = 450_000_000     # one contig per group (padded 512M records)
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    rss = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log = lambda m: print(f"[wgs +{time.time()-T0:7.1f}s rss {rss():5.1f}G] {m}",
                          flush=True)
    T0 = time.time()

    from isaac_aligner_tpu.io.fasta import ContigMeta, Genome  # noqa: E402

    # ---- 1. synthetic GRCh38-scale genome (repeat-seeded, chunked gen) ----
    log(f"generating {N/1e6:.0f} Mbp genome")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, N, dtype=np.uint8)   # no int64 spike
    # mobile-element families (~5%): diverged copies force realistic repeat
    # handling in seeds/neighbors/MAPQ
    for elem_len, copies, div in ((600, N // 25_000, 0.02),
                                  (2_000, N // 150_000, 0.01),
                                  (6_000, N // 1_500_000, 0.05)):
        elem = rng.integers(0, 4, elem_len).astype(np.uint8)
        pos = rng.integers(0, N - elem_len, copies)
        for p in pos:
            mut = rng.random(elem_len) < div
            codes[p : p + elem_len] = np.where(
                mut, rng.integers(0, 4, elem_len), elem)
    contigs = []
    off = 0
    i = 0
    while off < N:
        ln = min(CONTIG, N - off)
        contigs.append(ContigMeta(index=i, name=f"chr{i+1}", offset=off,
                                  length=ln, md5="0" * 32))
        off += ln
        i += 1
    genome = Genome(codes=codes, contigs=contigs)
    log(f"{len(contigs)} contigs")

    # ---- 2. grouped streaming index build --------------------------------
    from isaac_aligner_tpu.index.groups import build_grouped_indexes  # noqa: E402

    idx_dir = work / "idx"
    (work / "scratch").mkdir(parents=True, exist_ok=True)
    if not args.skip_build:
        t0 = time.time()
        build_grouped_indexes(genome, idx_dir, limit=GROUP_LIMIT, seed_len=32,
                              streaming=True, annotate_neighbors=False,
                              work_dir=work / "scratch")
        t_build = time.time() - t0
        n_groups = len(list(idx_dir.glob("group_*")))
        log(f"grouped index built: {n_groups} groups in {t_build:.0f}s "
            f"({t_build/3600:.2f} h; reference human build ~11 h/24 threads)")
    else:
        t_build = None
        log("reusing existing index")

    # ---- 3. paired reads --------------------------------------------------
    from isaac_aligner_tpu import dna  # noqa: E402

    READ = 100
    n_pairs = args.pairs
    if not args.skip_align:
        log(f"writing {n_pairs} read pairs")
        qs = "?" * READ
        starts = rng.integers(0, N - 600, n_pairs)
        with open(work / "r1.fq", "w") as f1, open(work / "r2.fq", "w") as f2:
            for j in range(n_pairs):
                p = int(starts[j])
                m1 = codes[p : p + READ].copy()
                mut = rng.random(READ) < 0.01
                m1[mut] = rng.integers(0, 4, int(mut.sum()))
                m2 = codes[p + 300 - READ : p + 300]
                rc = np.where(m2[::-1] < 4, 3 - m2[::-1], m2[::-1])
                f1.write(f"@r{j}\n{dna.decode(m1)}\n+\n{qs}\n")
                f2.write(f"@r{j}\n{dna.decode(rc)}\n+\n{qs}\n")

        # ---- 4. e2e through the workflow (group-major auto) ----------------
        del codes, genome     # the workflow reloads; keep RSS honest
        import gc
        gc.collect()
        from isaac_aligner_tpu.workflow.align import (AlignWorkflow,  # noqa: E402
                                                      WorkflowOptions)
        log("e2e FASTQ -> sorted BAM (single timed run; compiles + group "
            "uploads included, reported separately)")
        t0 = time.time()
        wf = AlignWorkflow(WorkflowOptions(
            reference=str(idx_dir), output_dir=str(work / "out"),
            fastq1=str(work / "r1.fq"), fastq2=str(work / "r2.fq"),
            batch_size=32_768, realign_gaps="no",
            records_per_bin=2_000_000))
        wf.run()
        e2e_s = time.time() - t0
        al = wf._stats.get("match_selector", {})
        doc = {
            "genome_mbp": N / 1e6,
            "groups": len(list(idx_dir.glob("group_*"))),
            "index_build_s": t_build,
            "e2e_wall_s": round(e2e_s, 1),
            "e2e_reads_per_sec": round(2 * n_pairs / e2e_s, 1),
            "align_s": al.get("align_seconds"),
            "stage_seconds": al.get("stage_seconds"),
            "aligned_frac": round(al.get("aligned", 0)
                                  / max(al.get("total_reads", 1), 1), 4),
            "proper_pairs": al.get("proper_pairs"),
            "build_s": wf._stats.get("build", {}).get("build_seconds"),
            "peak_rss_gb": round(rss(), 2),
        }
        log("RESULT " + json.dumps(doc))
        (work / "wgs_result.json").write_text(json.dumps(doc, indent=2))


if __name__ == "__main__":
    main()
