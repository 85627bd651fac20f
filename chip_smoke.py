"""Smoke run of the aligner's main path on one NVIDIA GPU.

    python chip_smoke.py                 # phases 0-4 on one card
    python chip_smoke.py --four-cards    # `align --devices 4` vs one card
                                         # (needs 4 GPUs)

Phases, in order, each failing the run when it fails:

0. device check: JAX's default device must be a GPU; prints the card's
   name and power limit, memory limit, host cores, native libraries.
1. banded SW at polish_gapped's shapes (block 512, L 100 and 150, bwa and
   eland scores), exact against the numpy oracle.
2. device neighbor annotation on a 2 Mbp slice, bit-exact against the
   host oracle; the partitioned program equals the single-sort one.
3. the main path through `cli.main`: `sort-reference` of a chr21-scale
   (46.7 Mbp) repeat-rich genome, then `align` of 524,288 2x100 bp read
   pairs (insert N(350, 50), 1% substitutions, ~2% of pairs with a
   1-10 bp indel in each mate, ~3% duplicate pairs) to a sorted BAM, run
   twice to check that the BAM is deterministic.
4. two 32,768-read batches through the same paired program on the GPU
   and on the CPU: core fields equal, MAPQ within the parity oracle's
   floor-flip bound.

--four-cards runs only `align --devices 4`, with and without
--shard-genome, on phase 3's data, against one card running both the
default program and the SPMD one; every pair of BAMs must be
byte-identical or pass phase 4's record rule.

The last line of standard output is one JSON object with the device.
Everything is generated from --seed; the work directory is a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

T0 = time.perf_counter()
READ_LEN = 100


@dataclasses.dataclass(frozen=True)
class Sizes:
    genome_bp: int = 46_700_000     # human chr21 (BASELINE.json rung 4)
    pairs: int = 524_288
    batch: int = 32_768             # align --batch-size
    slice_bp: int = 2_000_000       # phase-2 oracle slice
    compare_pairs: int = 16_384     # phase 4: 32,768 reads per batch
    sw_block: int = 512             # polish_gapped's device block


def log(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def _import_package():
    try:
        import isaac_aligner_tpu  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke.py runs from the root of a checkout "
                         f"of the aligner: {e}") from e


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    """Refuse anything but a GPU; report what the run has."""
    import jax

    from isaac_aligner_tpu.native import load_library
    from isaac_aligner_tpu.utils.device import (gpu_name_and_power_limit,
                                                require_gpu)

    dev = require_gpu()
    card = gpu_name_and_power_limit()
    stats = dev.memory_stats() or {}
    libs = {n: load_library(n) is not None
            for n in ("bgzf", "bamrec", "scatter")}
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"jax {jax.__version__}: {dev.platform} {dev.device_kind} x"
        f"{len(jax.devices())}, bytes_limit {stats.get('bytes_limit')}, "
        f"host cores {os.cpu_count()}, native libraries {libs}")
    if not all(libs.values()):
        raise RuntimeError(f"native libraries failed to load: {libs}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def polish_like_pairs(rng, n: int, l: int):
    """(query, window) pairs shaped like polish_gapped's: half are reads cut
    from their window with an indel and substitutions, half random."""
    from isaac_aligner_tpu.ops import sw
    db = rng.integers(0, 4, (n, l + sw.BAND - 1)).astype(np.int32)
    q = rng.integers(0, 5, (n, l)).astype(np.int32)
    for i in range(n // 2):
        off = int(rng.integers(0, 8))
        cut = int(rng.integers(10, l - 10))
        gap = int(rng.integers(1, 6))
        src = np.concatenate([db[i, off : off + cut],
                              db[i, off + cut + gap :]])
        q[i] = np.resize(src, l)
        subs = rng.random(l) < 0.05
        q[i, subs] = (q[i, subs] + 1) % 4
    return q, db


def phase_sw(sizes: Sizes, rng) -> None:
    import jax

    from isaac_aligner_tpu.ops import sw

    for l in (100, 150):
        for name, scores in (("bwa", sw.BWA_SCORES),
                             ("eland", sw.ELAND_SCORES)):
            q, db = polish_like_pairs(rng, sizes.sw_block, l)
            t0 = time.perf_counter()
            g, tb = jax.device_get(sw.banded_sw_jit(q, db, scores))
            first = time.perf_counter() - t0
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(sw.banded_sw_jit(q, db, scores))
                ts.append(time.perf_counter() - t0)
            g_ref, tb_ref = sw.banded_sw_numpy_batch(q, db, scores)
            np.testing.assert_array_equal(g, g_ref)
            np.testing.assert_array_equal(tb, tb_ref)
            log(f"SW L={l} {name} block={sizes.sw_block}: exact vs oracle; "
                f"first call {first:.3f}s, call median "
                f"{1e3 * float(np.median(ts)):.3f} ms")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def make_genome(n: int, rng):
    from scripts.neighbor_scale_proof import make_genome as _make
    return _make(n, rng)


def unique_planes(index):
    from isaac_aligner_tpu.index.build import unbias_i32_to_u32
    hi = unbias_i32_to_u32(np.asarray(index.key_hi)).astype(np.uint64)
    lo = unbias_i32_to_u32(np.asarray(index.key_lo)).astype(np.uint64)
    uniq = np.unique((hi << np.uint64(32)) | lo)
    return ((uniq >> np.uint64(32)).astype(np.uint32),
            (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def phase_neighbors(sizes: Sizes, rng) -> None:
    from isaac_aligner_tpu.index.build import build_index
    from isaac_aligner_tpu.index.neighbors import annotate_index
    from isaac_aligner_tpu.index.neighbors_tpu import find_neighbors_device

    idx = build_index(make_genome(sizes.slice_bp, rng), seed_len=32)
    t0 = time.perf_counter()
    host = annotate_index(idx.key_hi, idx.key_lo, k=32, prefer_device=False)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = annotate_index(idx.key_hi, idx.key_lo, k=32, prefer_device=True)
    t_dev = time.perf_counter() - t0
    if not np.array_equal(host, dev):
        raise AssertionError(f"device neighbor bits differ from the host "
                             f"oracle in {int((host != dev).sum())} records")
    planes = unique_planes(idx)
    whole = find_neighbors_device(planes, 32)
    cap = max(planes[0].size // 3, 1)
    parted = find_neighbors_device(planes, 32, sort_max=cap)
    if not np.array_equal(whole, parted):
        raise AssertionError("partitioned device annotation differs")
    log(f"neighbors on {sizes.slice_bp / 1e6:.0f} Mbp ({idx.num_records} "
        f"records, {planes[0].size} unique k-mers): device == host oracle "
        f"({int(dev.sum())} bits; host {t_host:.1f}s, device {t_dev:.1f}s); "
        f"partitioned (sort bound {cap}) == single sort")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    r = codes[..., ::-1]
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def write_fasta(path: Path, codes: np.ndarray, name: str) -> None:
    seq = _ASCII[codes]
    width = 70
    full = seq.size // width
    body = np.concatenate([seq[: full * width].reshape(full, width),
                           np.full((full, 1), ord("\n"), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(body.tobytes())
        if seq.size % width:
            f.write(seq[full * width:].tobytes() + b"\n")


def make_pairs(genome_codes: np.ndarray, n: int, rng):
    """Paired 2x100 bp reads: (r1 [n, L] codes, r2 [n, L], meta)."""
    g = genome_codes
    gl = g.size
    ins = np.clip(np.rint(rng.normal(350, 50, n)), 2 * READ_LEN, 650
                  ).astype(np.int64)
    start = rng.integers(0, gl - 700, n)
    # ~3% duplicate pairs: copies of another pair's fragment
    dup = rng.random(n) < 0.03
    src = rng.integers(0, n, n)
    start = np.where(dup, start[src], start)
    ins = np.where(dup, ins[src], ins)
    cols = np.arange(READ_LEN)
    fwd = g[start[:, None] + cols]
    mate = revcomp(g[(start + ins - READ_LEN)[:, None] + cols])
    # ~2% of pairs carry a 1-10 bp indel in each mate
    indel = np.nonzero(rng.random(n) < 0.02)[0]
    for i in indel:
        for which in (0, 1):
            size = int(rng.integers(1, 11))
            at = int(rng.integers(25, 76))
            s = int(start[i]) if which == 0 else int(start[i] + ins[i]
                                                      - READ_LEN)
            if rng.random() < 0.5:       # deletion from the read
                seg = np.concatenate([g[s : s + at],
                                      g[s + at + size : s + READ_LEN + size]])
            else:                        # insertion into the read
                seg = np.concatenate([g[s : s + at],
                                      rng.integers(0, 4, size).astype(np.uint8),
                                      g[s + at : s + READ_LEN - size]])
            if which == 0:
                fwd[i] = seg
            else:
                mate[i] = revcomp(seg)
    subs = rng.random(fwd.shape) < 0.01
    fwd = np.where(subs, (fwd + 1) % 4, fwd).astype(np.uint8)
    subs = rng.random(mate.shape) < 0.01
    mate = np.where(subs, (mate + 1) % 4, mate).astype(np.uint8)
    # half the fragments come from the reverse strand: swap the mates
    swap = rng.random(n) < 0.5
    r1 = np.where(swap[:, None], mate, fwd)
    r2 = np.where(swap[:, None], fwd, mate)
    return r1, r2, {"indel_pairs": int(indel.size),
                    "duplicate_pairs": int(dup.sum())}


def write_fastq(path: Path, reads: np.ndarray) -> None:
    qual = b"?" * reads.shape[1]                   # phred 30
    seqs = _ASCII[reads]
    with open(path, "wb") as f:
        f.write(b"".join(b"@p%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual)
                         for i in range(reads.shape[0])))


class _Counted:
    """Counts calls and seconds of one module attribute while installed."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = 0
        self.seconds = 0.0
        self._lock = threading.Lock()      # polish runs on worker threads

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.orig(*a, **kw)
        finally:
            with self._lock:
                self.calls += 1
                self.seconds += time.perf_counter() - t0

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _ComputeApps(threading.Thread):
    """Polls `nvidia-smi --query-compute-apps` (the poller stays off JAX)
    and keeps every pid seen on the card."""

    def __init__(self, period: float = 2.0):
        super().__init__(daemon=True)
        self.period = period
        self.pids: set[str] = set()
        self.samples = 0
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60)
            self.samples += 1
            for line in out.stdout.splitlines():
                if line.strip():
                    self.pids.add(line.split(",")[0].strip())
            self._halt.wait(self.period)

    def stop(self):
        self._halt.set()
        self.join(timeout=60)


def prepare_main_path(sizes: Sizes, rng, work: Path) -> dict:
    """Genome FASTA, read FASTQs and the sorted reference of phase 3."""
    from isaac_aligner_tpu import cli
    from isaac_aligner_tpu.index import neighbors_tpu

    t0 = time.perf_counter()
    genome = make_genome(sizes.genome_bp, rng)
    write_fasta(work / "ref.fa", genome.codes, "chr21_sim")
    r1, r2, meta = make_pairs(genome.codes, sizes.pairs, rng)
    write_fastq(work / "r1.fq", r1)
    write_fastq(work / "r2.fq", r2)
    log(f"generated {sizes.genome_bp / 1e6:.1f} Mbp genome and "
        f"{sizes.pairs} pairs ({meta}) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    with _Counted(neighbors_tpu, "find_neighbors_device") as ann:
        rc = cli.main(["sort-reference", "-g", str(work / "ref.fa"),
                       "-o", str(work / "idx")])
    t_index = time.perf_counter() - t0
    if rc != 0 or ann.calls != 1:
        raise RuntimeError(f"sort-reference rc={rc}, device annotation "
                           f"calls {ann.calls}")
    log(f"sort-reference: {t_index:.1f}s in all, of which device neighbor "
        f"annotation {ann.seconds:.1f}s")
    return {"r1": r1, "r2": r2, "index_s": t_index,
            "annotation_s": ann.seconds}


def run_align(sizes: Sizes, work: Path, out: str, *extra: str) -> dict:
    """One `align` through cli.main; returns wall, stats and BAM md5."""
    from isaac_aligner_tpu import cli
    from isaac_aligner_tpu.align import gapped
    from isaac_aligner_tpu.ops import sw

    with _Counted(sw, "banded_sw_jit") as swc, \
            _Counted(gapped, "polish_gapped") as pol:
        t0 = time.perf_counter()
        rc = cli.main(["align", "-r", str(work / "idx"),
                       "-1", str(work / "r1.fq"), "-2", str(work / "r2.fq"),
                       "-o", str(work / out),
                       "--batch-size", str(sizes.batch), *extra])
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"align {out} rc={rc}")
    o = work / out
    for f in ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5"):
        if not (o / f).is_file():
            raise AssertionError(f"align {out}: {f} missing")
    ms = json.loads((o / "Stats" / "MatchSelectorStats.json").read_text())
    return {"wall": wall, "stats": ms, "sw_calls": swc.calls,
            "polish_calls": pol.calls,
            "md5": (o / "sorted.bam.md5").read_text().split()[0],
            "bam": o / "sorted.bam"}


def phase_main_path(sizes: Sizes, rng, work: Path, card: str) -> dict:
    data = prepare_main_path(sizes, rng, work)
    n_batches = -(-sizes.pairs // sizes.batch)
    apps = _ComputeApps()
    apps.start()
    try:
        cold = run_align(sizes, work, "out1")
        warm = run_align(sizes, work, "out2")
    finally:
        apps.stop()
    reads = 2 * sizes.pairs
    ms = cold["stats"]
    aligned = ms["aligned"] / ms["total_reads"]
    proper = 2 * ms["proper_pairs"] / ms["total_reads"]
    log(f"align: {ms['total_reads']} reads, aligned {aligned:.4f}, "
        f"proper pairs {proper:.4f}; device SW calls {cold['sw_calls']} "
        f"over {cold['polish_calls']} polish calls ({n_batches} batches)")
    log(f"[{card}] index build {data['index_s']:.1f}s (annotation "
        f"{data['annotation_s']:.1f}s); align cold {cold['wall']:.1f}s, "
        f"warm {warm['wall']:.1f}s => cold compile ~"
        f"{cold['wall'] - warm['wall']:.1f}s, warm {reads / warm['wall']:.0f} "
        f"reads/s; stage seconds (summed over threads) "
        f"{warm['stats'].get('stage_seconds')}")
    log(f"nvidia-smi compute apps during align: pids {sorted(apps.pids)} "
        f"over {apps.samples} samples (this process {os.getpid()})")
    if aligned < 0.9 or proper < 0.8:
        raise AssertionError(f"aligned {aligned:.4f}, proper {proper:.4f}")
    if cold["sw_calls"] < n_batches:
        raise AssertionError(f"{cold['sw_calls']} device SW calls for "
                             f"{n_batches} batches")
    if len(apps.pids) > 1:
        raise AssertionError(f"{len(apps.pids)} processes on the card")
    same = cold["md5"] == warm["md5"]
    log(f"BAM md5 run 1 {cold['md5']}, run 2 {warm['md5']}: "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the BAM differs between two identical runs")
    return data


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

CORE = ("aligned", "start", "reverse", "mismatches", "edit_distance")
PAIR = ("proper_pair", "pair_resolved")


def _paired_aligner(work: Path, sizes: Sizes):
    from isaac_aligner_tpu.aligner import PairedAligner
    from isaac_aligner_tpu.index.build import SeedIndex
    from isaac_aligner_tpu.workflow.align import (AlignWorkflow,
                                                  WorkflowOptions)

    index = SeedIndex.load(work / "idx")
    wf = AlignWorkflow(WorkflowOptions(
        reference=str(work / "idx"), output_dir=str(work / "cmp"),
        fastq1=str(work / "r1.fq"), fastq2=str(work / "r2.fq"),
        batch_size=sizes.compare_pairs))
    return PairedAligner.create(index, read_len=READ_LEN,
                                cfg=wf._align_config(READ_LEN, index))


def _batches(data: dict, sizes: Sizes, count: int = 2):
    from isaac_aligner_tpu.io.fastq import ReadBatch
    n = sizes.compare_pairs
    q = np.full((n, READ_LEN), 30, np.uint8)
    ln = np.full(n, READ_LEN, np.int32)
    out = []
    for b in range(count):
        rows = slice(b * n, (b + 1) * n)
        names = [f"p{i}" for i in range(rows.start, rows.stop)]
        out.append((ReadBatch(names, data["r1"][rows], q, ln),
                    ReadBatch(names, data["r2"][rows], q.copy(), ln)))
    return out


def phase_gpu_vs_cpu(sizes: Sizes, data: dict, work: Path) -> None:
    import jax

    batches = _batches(data, sizes)
    gpu = _paired_aligner(work, sizes)
    gpu.learn_tls(batches)

    def timed(b):
        t0 = time.perf_counter()
        gpu.align_batch_arrays(*b)
        return time.perf_counter() - t0

    t_cold = timed(batches[0])
    jax.clear_caches()
    t_warm = timed(batches[0])
    t_run = timed(batches[0])
    log(f"paired program, batch {sizes.compare_pairs} pairs: first call "
        f"{t_cold:.1f}s, after clearing in-memory caches {t_warm:.1f}s "
        f"(persistent cache), compiled {t_run:.2f}s => compile cold ~"
        f"{t_cold - t_run:.1f}s, warm ~{t_warm - t_run:.1f}s")
    res_gpu = [gpu.align_batch_arrays(*b) for b in batches]

    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = _paired_aligner(work, sizes)
        cpu.tls = gpu.tls
        t0 = time.perf_counter()
        res_cpu = [cpu.align_batch_arrays(*b) for b in batches]
    log(f"same program on {cpu_dev.device_kind}: "
        f"{time.perf_counter() - t0:.1f}s for {len(batches)} batches")

    flips = rows_total = 0
    for rg, rc in zip(res_gpu, res_cpu):
        for end in ("_1", "_2"):
            for f in CORE:
                np.testing.assert_array_equal(
                    rg[f + end], rc[f + end], err_msg=f"field {f}{end}")
            if rg.get("cigar" + end) != rc.get("cigar" + end):
                raise AssertionError(f"cigar{end} differs")
        for f in PAIR:
            np.testing.assert_array_equal(rg[f], rc[f], err_msg=f"field {f}")
        # MAPQ is min(60, max/min) of these scores (aligner._pair_records)
        for f, rows in (("frag_score_1", rg["aligned_1"]),
                        ("frag_score_2", rg["aligned_2"]),
                        ("template_score", rg["aligned_1"] & rg["aligned_2"])):
            rows = np.nonzero(rows)[0]
            d = np.abs(rg[f][rows].astype(np.int64)
                       - rc[f][rows].astype(np.int64))
            if d.max(initial=0) > 1:
                raise AssertionError(f"{f} differs by {d.max()}")
            flips += int((d > 0).sum())
            rows_total += rows.size
    bound = max(2, int(0.005 * rows_total))
    log(f"GPU vs CPU on {2 * len(batches) * sizes.compare_pairs} reads: "
        f"{CORE}, cigars and {PAIR} equal; MAPQ score floor flips "
        f"{flips}/{rows_total} (bound {bound})")
    if flips > bound:
        raise AssertionError(f"{flips} MAPQ score flips > bound {bound}")


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def phase_four_cards(sizes: Sizes, rng, work: Path, card: str) -> None:
    """`align --devices 4` (with and without --shard-genome) against one
    card.  The multi-card runs use the SPMD paired program, whose rescue
    runs in-program; so one card runs both the default program and the
    SPMD one (ISAAC_TPU_INLINE_RESCUE=1), and each pair of BAMs is
    compared: byte identity, else phase 4's record rule."""
    import jax

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX found "
                         f"{len(jax.devices())}")
    prepare_main_path(sizes, rng, work)
    one = run_align(sizes, work, "out1")
    os.environ["ISAAC_TPU_INLINE_RESCUE"] = "1"
    try:
        one_spmd = run_align(sizes, work, "out1s")
    finally:
        del os.environ["ISAAC_TPU_INLINE_RESCUE"]
    four = run_align(sizes, work, "out4", "--devices", "4")
    shard = run_align(sizes, work, "out4g", "--devices", "4",
                      "--shard-genome")
    for d in jax.devices()[:4]:
        st = d.memory_stats() or {}
        log(f"{d}: bytes_in_use {st.get('bytes_in_use')}, peak "
            f"{st.get('peak_bytes_in_use')}, limit {st.get('bytes_limit')}")
    reads = 2 * sizes.pairs
    log(f"[{card}] align 1 card {one['wall']:.1f}s "
        f"({reads / one['wall']:.0f} reads/s, cold), 1 card SPMD "
        f"{one_spmd['wall']:.1f}s, 4 cards {four['wall']:.1f}s, 4 cards "
        f"genome-sharded {shard['wall']:.1f}s (each includes its own "
        f"compiles)")
    failed = []
    for name, ref, r in (
            ("--devices 4 vs 1-card SPMD", one_spmd, four),
            ("--devices 4 --shard-genome vs 1-card SPMD", one_spmd, shard),
            ("1-card SPMD vs 1-card default", one, one_spmd)):
        if r["bam"].read_bytes() == ref["bam"].read_bytes():
            log(f"{name}: BAM byte-identical (md5 {r['md5']})")
            continue
        log(f"{name}: BAMs differ (md5 {r['md5']} vs {ref['md5']})")
        try:
            compare_bams(ref["bam"], r["bam"], name)
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))


def bam_fields(path: Path) -> dict:
    """{(qname, read1/read2 bits): (ref_id, pos, flag, cigar, tlen, mapq)}
    for every record of a BAM (sequence, qualities and tags skipped)."""
    import struct

    from isaac_aligner_tpu.io import bgzf
    data = bgzf.decompress(Path(path).read_bytes())
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    out = {}
    while off < len(data):
        (size, ref_id, pos, l_rn, mapq, _bin, n_cig, flag, _l_seq, _nref,
         _npos, tlen) = struct.unpack_from("<iiiBBHHHiiii", data, off)
        rec = off + 36
        qname = data[rec : rec + l_rn - 1]
        cigar = data[rec + l_rn : rec + l_rn + 4 * n_cig]
        out[(qname, flag & 0xC0)] = (ref_id, pos, flag, cigar, tlen, mapq)
        off += 4 + size
    return out


def compare_bams(ref_bam: Path, other_bam: Path, name: str) -> None:
    """Phase 4's rule on two BAMs: every record's position, flags
    (duplicate mark included), cigar and template length equal; MAPQ
    within +-1 in at most the parity oracle's share of records."""
    a, b = bam_fields(ref_bam), bam_fields(other_bam)
    if a.keys() != b.keys():
        raise AssertionError(f"{name}: {len(a.keys() ^ b.keys())} records "
                             f"present in only one BAM")
    core = [k for k in a if a[k][:5] != b[k][:5]]
    d = np.array([abs(a[k][5] - b[k][5]) for k in a], np.int64)
    flips = int((d > 0).sum())
    bound = max(2, int(0.005 * len(a)))
    log(f"{name}: {len(a)} records, {len(core)} differ in position, "
        f"flags, cigar or template length; MAPQ differs in {flips} "
        f"(max {int(d.max(initial=0))}, bound {bound})")
    for k in core[:5]:
        log(f"  {k[0].decode()} {k[1]:#x}: {a[k]} vs {b[k]}")
    if core or d.max(initial=0) > 1 or flips > bound:
        raise AssertionError(f"{name}: records differ beyond MAPQ flips")


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only `align --devices 4` (with and without "
                         "--shard-genome) against one card")
    args = ap.parse_args(argv)
    _import_package()
    from isaac_aligner_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    device = phase_device()
    log(f"compile cache: {cache}")
    sizes = Sizes()
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="isaac_smoke_") as tmp:
        work = Path(tmp)
        if args.four_cards:
            phase_four_cards(sizes, rng, work, device["card"])
        else:
            phase_sw(sizes, rng)
            phase_neighbors(sizes, rng)
            data = phase_main_path(sizes, rng, work, device["card"])
            phase_gpu_vs_cpu(sizes, data, work)
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
