"""Group-major swapping (one index group resident on the device at a
time) must produce byte-identical output to the all-resident multi-index
path."""

import numpy as np

from isaac_aligner_tpu.io.bam import read_bam
from isaac_aligner_tpu.workflow import align as align_mod
from isaac_aligner_tpu.workflow.align import AlignWorkflow, WorkflowOptions


def test_group_major_byte_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(23)
    seqs = []
    for c in range(3):
        codes = rng.integers(0, 4, 30_000).astype(np.uint8)
        seqs.append((f"c{c}", codes))
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(
        f">{n}\n" + "".join("ACGT"[x] for x in codes) + "\n"
        for n, codes in seqs))

    # grouped reference: one contig per group
    from isaac_aligner_tpu.index.groups import build_grouped_indexes
    from isaac_aligner_tpu.io.fasta import read_fasta
    genome = read_fasta(fa)
    build_grouped_indexes(genome, tmp_path / "idx", limit=40_000,
                          seed_len=32)

    qs = "I" * 80
    with open(tmp_path / "r1.fq", "w") as f1, \
            open(tmp_path / "r2.fq", "w") as f2:
        for i in range(200):
            _, codes = seqs[i % 3]
            t = 300 + int(rng.integers(-20, 21))
            p = int(rng.integers(0, 30_000 - t - 1))
            s1 = "".join("ACGT"[x] for x in codes[p : p + 80])
            m2 = codes[p + t - 80 : p + t]
            rc = np.where(m2[::-1] < 4, 3 - m2[::-1], m2[::-1])
            f1.write(f"@q{i}\n{s1}\n+\n{qs}\n")
            f2.write(f"@q{i}\n{''.join('ACGT'[x] for x in rc)}\n+\n{qs}\n")

    def run(name):
        AlignWorkflow(WorkflowOptions(
            reference=str(tmp_path / "idx"), output_dir=str(tmp_path / name),
            fastq1=str(tmp_path / "r1.fq"), fastq2=str(tmp_path / "r2.fq"),
            batch_size=64, tls_batches=2, records_per_bin=10_000)).run()
        return (tmp_path / name / "sorted.bam").read_bytes()

    resident = run("out_resident")
    monkeypatch.setattr(align_mod, "device_plane_budget",
                        lambda: 1.0)                  # force swapping
    swapped = run("out_swapped")
    assert resident == swapped
    recs = read_bam(tmp_path / "out_resident" / "sorted.bam")[2]
    aligned = [r for r in recs if not (r.flag & 4)]
    assert len(aligned) >= 380          # nearly all 400 records
    assert {r.rname for r in aligned} == {"c0", "c1", "c2"}


def test_plane_budget_from_device_memory(monkeypatch):
    """The resident-plane budget is a share of the device's bytes_limit,
    and of host RAM for a device that reports no limit."""
    import os

    import jax

    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [Dev({"bytes_limit": 10_000_000_000})])
    assert align_mod.device_plane_budget() == (
        align_mod.PLANE_BUDGET_SHARE * 10_000_000_000)
    monkeypatch.setattr(jax, "devices", lambda *a: [Dev(None)])
    ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert align_mod.device_plane_budget() == (
        align_mod.PLANE_BUDGET_SHARE * ram)
