"""Alignment throughput benchmark — prints a JSON line after EVERY
completed section (the driver parses the LAST line, so a timeout still
yields every metric measured so far).

Measures, on the GPU (it refuses to run on any other backend), against a
REPEAT-RICH synthetic E. coli-scale genome (4.6 Mbp
with diverged mobile-element copies and an N island; round-1 review:
uniform-random genomes hide repeat handling):

- reads/s/chip, single-end fused pipeline (headline metric) + honesty
  stats (aligned fraction, MAPQ0 fraction, pass-2 drop count)
- end-to-end FASTQ -> sorted BAM reads/s (single-end, then paired)
  through the streaming workflow
- paired-end (2x100bp) device reads/s
- banded Smith-Waterman GCUPS

Sections run HEADLINE-FIRST and each has a wall-budget guard: when the
remaining budget can't cover a section's worst-case cost it is skipped
and reported as skipped instead of silently eating the run (round-3
lesson: BENCH_r03 was rc=124 with zero parsed output because everything
rode on one final print).  A section that raises is recorded in the
output and the run exits nonzero once the remaining sections finished.

Timing methodology: device metrics enqueue many distinct batches and
fetch a device-reduced scalar per batch — a fetch only returns once its
program finished, and programs execute in submission order, so the wall
time covers real completion while cross-batch pipelining (the production
schedule) is preserved.

Baseline for `vs_baseline`: reference iSAAC (Raczy et al., Bioinformatics
2013) aligns a 40x human genome (~1.28e9 2x100bp reads) in ~5.5 h on one
24-core 2.6 GHz node => ~6.5e4 reads/s/node.  The repo itself publishes
no benchmark numbers (BASELINE.md), so this paper-scale figure is the
documented stand-in; vs_baseline = ours / 64600.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC = 64_600.0

GENOME_LEN = 4_600_000
READ_LEN = 100
BATCH = 32_768
E2E_READS = 524_288

_T0 = time.time()
# overall wall budget (driver timeout is ~30 min; leave flush slack)
BUDGET_S = float(os.environ.get("ISAAC_BENCH_BUDGET_S", "1560"))


def _log(msg):
    print(f"[bench +{time.time() - _T0:6.1f}s] {msg}", file=sys.stderr)


class Emitter:
    """Accumulates the result JSON and re-prints it after every section."""

    def __init__(self):
        self.failed = False
        self.doc = {
            "metric": "reads_per_sec_per_chip",
            "value": 0.0,
            "unit": "reads/s",
            "vs_baseline": 0.0,
            "detail": {
                "read_len": READ_LEN,
                "batch": BATCH,
                "genome": "repeat-rich 4.6Mbp (600bp x200 + 2kb x30 "
                          "elements, N island)",
                "timing": "enqueue-many + device-reduced scalar fetches "
                          "(fetch forces completion)",
                "sections_done": [],
                "sections_skipped": [],
            },
        }

    def headline(self, rps: float):
        self.doc["value"] = round(rps, 1)
        self.doc["vs_baseline"] = round(rps / BASELINE_READS_PER_SEC, 3)

    def emit(self):
        print(json.dumps(self.doc), flush=True)

    def left(self) -> float:
        return BUDGET_S - (time.time() - _T0)

    def run(self, name: str, need_s: float, fn):
        """Run one section under the budget guard; a failure or a skip is
        recorded in the output instead of killing the bench."""
        d = self.doc["detail"]
        if self.left() < need_s:
            _log(f"SKIP {name}: {self.left():.0f}s left < {need_s:.0f}s budget")
            d["sections_skipped"].append(
                {"name": name, "left_s": round(self.left(), 1),
                 "need_s": need_s})
            self.emit()
            return False
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # keep later sections alive
            _log(f"FAIL {name}: {e!r}")
            self.failed = True
            d["sections_skipped"].append({"name": name, "error": repr(e)[:300]})
            self.emit()
            return False
        d["sections_done"].append(
            {"name": name, "wall_s": round(time.time() - t0, 1)})
        self.emit()
        return True


def make_genome(rng):
    """Repeat-rich synthetic genome: diverged 600bp/2kb element families
    (~5% of the genome) + a 1kb N island."""
    codes = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)

    def paste(elem, copies, divergence):
        for _ in range(copies):
            pos = int(rng.integers(0, GENOME_LEN - len(elem)))
            mut = rng.random(len(elem)) < divergence
            copy = np.where(mut, rng.integers(0, 4, len(elem)), elem)
            codes[pos : pos + len(elem)] = copy

    paste(rng.integers(0, 4, 600).astype(np.uint8), 200, 0.02)
    paste(rng.integers(0, 4, 2000).astype(np.uint8), 30, 0.01)
    codes[3_000_000 : 3_001_000] = 4   # N island
    from isaac_aligner_tpu.io.fasta import ContigMeta, Genome
    return Genome(codes=codes,
                  contigs=[ContigMeta(index=0, name="ecoli_sim", offset=0,
                                      length=GENOME_LEN, md5="0" * 32)])


def make_reads(seq_codes, rng, n, mutate=0.01):
    starts = rng.integers(0, GENOME_LEN - READ_LEN, n)
    reads = seq_codes[starts[:, None] + np.arange(READ_LEN)[None, :]]
    mut = rng.random(reads.shape) < mutate
    reads = np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(np.uint8)
    rc = reads[:, ::-1]
    rc = np.where(rc < 4, 3 - rc, rc).astype(np.uint8)
    flip = rng.random(n) < 0.5
    reads = np.where(flip[:, None], rc, reads)
    quals = np.full(reads.shape, 30, np.uint8)
    return reads, quals


def throughput_time(step, inputs_list):
    """Wall time for all calls: enqueue every program, then fetch each
    call's device-REDUCED scalar — a fetch can only return once its
    program finished, and programs execute in submission order, so the
    measurement covers real completion.  step must reduce its full output
    to one scalar ON DEVICE (so nothing is dead-code-eliminated and
    transfer cost stays negligible)."""
    import jax

    jax.device_get(step(*inputs_list[0]))   # compile + first-fetch flush
    t0 = time.time()
    outs = [step(*args) for args in inputs_list]
    for o in outs:
        float(jax.device_get(o))
    return time.time() - t0


def main() -> None:
    em = Emitter()
    det = em.doc["detail"]

    import jax
    import jax.numpy as jnp

    from isaac_aligner_tpu.utils.compile_cache import enable_compile_cache
    from isaac_aligner_tpu.utils.device import (gpu_name_and_power_limit,
                                                require_gpu)

    enable_compile_cache()
    dev = require_gpu()
    det["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices()),
                     "nvidia_smi": gpu_name_and_power_limit()}
    _log(f"device: {det['device']}")
    em.emit()

    from isaac_aligner_tpu.align.pipeline import (AlignConfig, align_batch,
                                                  align_batch_jit,
                                                  bucket_params_for,
                                                  default_seed_offsets,
                                                  genome_has_n_for,
                                                  prepare_index)
    from isaac_aligner_tpu.index.build import build_index

    rng = np.random.default_rng(0)
    _log("generating genome")
    genome = make_genome(rng)
    seq_codes = genome.codes
    _log("building index")
    t0 = time.time()
    index = build_index(genome, seed_len=32)
    det["index_build_s"] = round(time.time() - t0, 1)
    _log(f"index built in {det['index_build_s']}s")

    bw, bl = bucket_params_for(index)
    cfg = AlignConfig(seed_len=32, seed_offsets=default_seed_offsets(READ_LEN, 32),
                      bucket_width=bw, bucket_log2=bl,
                      genome_has_n=genome_has_n_for(index))
    arrays = prepare_index(index)

    def tree_sum(out):
        return sum(jnp.sum(v).astype(jnp.float32) for v in out.values()
                   if hasattr(v, "dtype"))

    # -- section 1: single-end device throughput + honesty stats -------------
    def sec_se_device():
        n_timed = 8
        se_inputs = []
        for i in range(n_timed):
            r, qq = make_reads(seq_codes, np.random.default_rng(100 + i), BATCH)
            se_inputs.append((jnp.asarray(r), jnp.asarray(qq)))
            jax.block_until_ready(se_inputs[-1])
        _log("staged SE batches")

        @jax.jit
        def se_step(bases, q):
            return tree_sum(align_batch(arrays, bases, q, cfg))

        _log("compiling + timing single-end pipeline")
        se_dt = throughput_time(se_step, se_inputs)
        rps = n_timed * BATCH / se_dt
        em.headline(rps)
        _log(f"single-end: {rps:.0f} reads/s")

        rd, qd = se_inputs[0]
        out = {k: np.asarray(v) for k, v in
               jax.device_get(align_batch_jit(arrays, rd, qd, cfg)).items()}
        aligned = out["aligned"]
        det["aligned_frac"] = round(float(aligned.mean()), 4)
        det["mapq0_frac"] = round(
            float((aligned & (out["mapq"] == 0)).sum() / max(aligned.sum(), 1)), 4)
        det["pass2_dropped"] = int(out.get("pass2_dropped", 0))

    em.run("se_device", 420, sec_se_device)

    # -- section 1b: the FULL packed product program (compute + fetch) -------
    def sec_se_packed():
        """The production single-end program exactly as the workflow runs
        it (_single_packed_jit: device trim/clip/align + compacted packed
        result) INCLUDING the full result fetch per batch — what the
        device and its host link sustain on the product path, without the
        host CPU stages the e2e figure below adds."""
        from isaac_aligner_tpu.aligner import Aligner, _single_packed_jit
        from isaac_aligner_tpu.io.fastq import ReadBatch

        al = Aligner.create(index, read_len=READ_LEN)
        n_timed = 8
        batches = []
        for i in range(n_timed):
            r, qq = make_reads(seq_codes, np.random.default_rng(500 + i),
                               BATCH)
            batches.append(ReadBatch([f"r{j}" for j in range(BATCH)], r, qq,
                                     np.full(BATCH, READ_LEN, np.int32)))

        def run_once():
            outs = [al._dispatch(b)[0][0] for b in batches]
            t0 = time.time()
            for o in outs:
                jax.device_get(o)
            return time.time() - t0

        run_once()                       # compile + flush
        dt = min(run_once() for _ in range(2))
        rps = n_timed * BATCH / dt
        det["se_packed_reads_per_sec"] = round(rps, 1)
        _log(f"single-end packed (compute+full fetch): {rps:.0f} reads/s")

    em.run("se_packed", 240, sec_se_packed)

    # -- sections 2+3: end-to-end FASTQ -> sorted BAM ------------------------
    import tempfile
    from pathlib import Path

    from isaac_aligner_tpu import dna
    from isaac_aligner_tpu.workflow.align import AlignWorkflow, WorkflowOptions

    tmp = tempfile.TemporaryDirectory(prefix="isaac_bench_")
    td = Path(tmp.name)
    index.save(td / "idx")
    qs = "?" * READ_LEN              # phred 30

    def run_e2e(name, fastq, fastq2=None, **kw):
        # WORKFLOW DEFAULTS (realign-gaps sample, 1M records/bin) unless
        # a variant overrides — round-4 review: the benched e2e skipped a
        # default-on compute stage
        opts = dict(reference=str(td / "idx"), output_dir=str(td / name),
                    fastq1=str(fastq), fastq2=fastq2, batch_size=BATCH)
        opts.update(kw)
        wf = AlignWorkflow(WorkflowOptions(**opts))
        t0 = time.time()
        wf.run()
        return time.time() - t0, wf

    def breakdown(wf):
        al = wf._stats.get("match_selector", {})
        return {
            "align_s": al.get("align_seconds"),
            **{f"{k}_s": v for k, v in al.get("stage_seconds", {}).items()},
            "build_s": wf._stats.get("build", {}).get("build_seconds"),
        }

    def sec_e2e_se():
        er, _eq = make_reads(seq_codes, rng, E2E_READS)
        _log("writing e2e FASTQ")
        with open(td / "r1.fq", "w") as f:
            f.writelines(f"@r{i}\n{dna.decode(er[i])}\n+\n{qs}\n"
                         for i in range(E2E_READS))
        # warmup run compiles the workflow's executables (same batch
        # shapes; the gapped-polish SW compile triggers on high-mismatch
        # rows, so inject some)
        warm, _wq = make_reads(seq_codes, rng, 4096, mutate=0.08)
        with open(td / "warm.fq", "w") as f:
            f.writelines(f"@w{i}\n{dna.decode(warm[i])}\n+\n{qs}\n"
                         for i in range(4096))
        _log("e2e warmup run (compiles)")
        run_e2e("warm_out", td / "warm.fq")
        _log("e2e timed run (workflow defaults)")
        e2e_s, wf = run_e2e("out", td / "r1.fq")
        rps = E2E_READS / e2e_s
        det["e2e_fastq_to_bam_reads_per_sec"] = round(rps, 1)
        if em.doc["value"]:
            det["e2e_fraction_of_device"] = round(rps / em.doc["value"], 3)
        det["e2e_breakdown_s"] = breakdown(wf)
        _log(f"e2e: {rps:.0f} reads/s ({e2e_s:.1f}s) {det['e2e_breakdown_s']}")
        _log("e2e timed run (no realign variant)")
        nr_s, _nr = run_e2e("out_nr", td / "r1.fq", realign_gaps="no",
                            records_per_bin=2_000_000)
        det["e2e_se_norealign_reads_per_sec"] = round(E2E_READS / nr_s, 1)
        _log(f"e2e no-realign: {E2E_READS / nr_s:.0f} reads/s")

    em.run("e2e_se", 420, sec_e2e_se)

    def sec_e2e_pe():
        n_pairs = E2E_READS // 2
        starts = rng.integers(0, GENOME_LEN - 500, n_pairs)
        m1 = seq_codes[starts[:, None] + np.arange(READ_LEN)[None, :]]
        mut1 = rng.random(m1.shape) < 0.01
        m1 = np.where(mut1, rng.integers(0, 4, m1.shape), m1).astype(np.uint8)
        m2 = seq_codes[(starts + 300 - READ_LEN)[:, None]
                       + np.arange(READ_LEN)[None, :]]
        m2 = np.where(m2[:, ::-1] < 4, 3 - m2[:, ::-1],
                      m2[:, ::-1]).astype(np.uint8)
        _log("writing paired e2e FASTQs")
        with open(td / "p1.fq", "w") as f:
            f.writelines(f"@p{i}\n{dna.decode(m1[i])}\n+\n{qs}\n"
                         for i in range(n_pairs))
        with open(td / "p2.fq", "w") as f:
            f.writelines(f"@p{i}\n{dna.decode(m2[i])}\n+\n{qs}\n"
                         for i in range(n_pairs))
        _log("paired e2e warmup run (compiles)")
        with open(td / "pw1.fq", "w") as f:
            f.writelines(f"@w{i}\n{dna.decode(m1[i])}\n+\n{qs}\n"
                         for i in range(4096))
        with open(td / "pw2.fq", "w") as f:
            f.writelines(f"@w{i}\n{dna.decode(m2[i])}\n+\n{qs}\n"
                         for i in range(4096))
        run_e2e("pwarm_out", td / "pw1.fq", str(td / "pw2.fq"))
        _log("paired e2e timed run (workflow defaults)")
        pe2e_s, pwf = run_e2e("pout", td / "p1.fq", str(td / "p2.fq"))
        rps = 2 * n_pairs / pe2e_s
        det["e2e_paired_reads_per_sec"] = round(rps, 1)
        det["e2e_paired_breakdown_s"] = breakdown(pwf)
        _log(f"paired e2e: {rps:.0f} reads/s ({pe2e_s:.1f}s) "
             f"{det['e2e_paired_breakdown_s']}")

    em.run("e2e_pe", 420, sec_e2e_pe)

    # -- section 4: paired-end device throughput -----------------------------
    def sec_pe_device():
        from isaac_aligner_tpu.align.pairs import TlsStatic, align_paired_batch

        pb = BATCH // 2
        pq = np.full((pb, READ_LEN), 30, np.uint8)
        tls = TlsStatic(min=200, max=400, mate_min=200, mate_max=400,
                        best0=1, best1=6)

        @jax.jit
        def pe_step(b1, q1, b2, q2):
            return tree_sum(align_paired_batch(arrays, b1, q1, b2, q2, cfg, tls))

        pe_inputs = []
        for i in range(4):
            rr = np.random.default_rng(200 + i)
            s = rr.integers(0, GENOME_LEN - 500, pb)
            e1 = seq_codes[s[:, None] + np.arange(READ_LEN)[None, :]]
            mm = seq_codes[(s + 300 - READ_LEN)[:, None]
                           + np.arange(READ_LEN)[None, :]]
            e2 = np.where(mm[:, ::-1] < 4, 3 - mm[:, ::-1],
                          mm[:, ::-1]).astype(np.uint8)
            mut2 = rr.random(e1.shape) < 0.01
            e1 = np.where(mut2, rr.integers(0, 4, e1.shape), e1).astype(np.uint8)
            pe_inputs.append(tuple(jnp.asarray(x) for x in (e1, pq, e2, pq)))

        _log("compiling + timing paired pipeline")
        pe_dt = throughput_time(pe_step, pe_inputs)
        rps = len(pe_inputs) * 2 * pb / pe_dt
        det["paired_reads_per_sec"] = round(rps, 1)
        _log(f"paired: {rps:.0f} reads/s")

    em.run("pe_device", 240, sec_pe_device)

    # -- section 5: banded SW GCUPS (chained slope) --------------------------
    def sec_gcups():
        from isaac_aligner_tpu.ops import sw
        n_pairs = 16_384
        q = jnp.asarray(rng.integers(0, 4, (n_pairs, READ_LEN)).astype(np.int32))
        db = jnp.asarray(rng.integers(0, 4, (n_pairs, READ_LEN + sw.BAND - 1)
                                      ).astype(np.int32))

        # chain R data-dependent DP calls inside ONE jit (runtime-dynamic
        # R => one compile) and take the slope between two chain lengths,
        # so per-call dispatch and fetch drop out
        @jax.jit
        def sw_chain(qq, dd, r):
            def body(i, acc):
                q2 = qq + jnp.where(acc > 1e30, 1, 0).astype(jnp.int32)
                g, tb = sw.banded_sw(q2, dd)
                return acc + g[0, 0] + tb[0, 0, 0].astype(jnp.float32)
            return jax.lax.fori_loop(0, r, body, jnp.float32(0))

        _log("compiling + timing banded-SW chain")
        jax.device_get(sw_chain(q, db, jnp.int32(16)))

        def sw_timed(r, reps=3):
            ts = []
            for _ in range(reps):
                t0 = time.time()
                jax.device_get(sw_chain(q, db, jnp.int32(r)))
                ts.append(time.time() - t0)
            return min(ts)

        # a 256-step slope keeps the difference well above timing noise
        sw_dt = (sw_timed(272) - sw_timed(16)) / 256
        gcups = n_pairs * READ_LEN * sw.BAND / sw_dt / 1e9
        det["banded_sw_gcups"] = round(gcups, 2)
        _log(f"banded SW: {gcups:.1f} GCUPS")

    em.run("sw_gcups", 150, sec_gcups)

    # -- section 6: shard_map overhead bound (1-device mesh) -----------------
    def sec_spmd_overhead():
        """SE throughput through the SPMD entry on a 1-device mesh: the
        plain/SPMD ratio bounds the shard_map + collective overhead the
        multi-card path pays per card."""
        from isaac_aligner_tpu.parallel.sharded import (
            make_mesh, place_sharded, shard_index, sharded_align_full)

        mesh = make_mesh(1, data=1, shard=1)
        sharded = place_sharded(mesh, shard_index(index, 1))

        @jax.jit
        def sp_step(sh, bases, q, tm, ln):
            res = sharded_align_full(mesh, sh, bases, q, cfg, tm, ln)
            return tree_sum(res)

        tm = jnp.zeros(BATCH, jnp.int32)
        ln = jnp.full(BATCH, READ_LEN, jnp.int32)
        inputs = []
        for i in range(4):
            r, qq = make_reads(seq_codes, np.random.default_rng(300 + i),
                               BATCH)
            inputs.append((sharded, jnp.asarray(r), jnp.asarray(qq), tm, ln))
        dt = throughput_time(sp_step, inputs)
        rps = 4 * BATCH / dt
        det["spmd_1dev_reads_per_sec"] = round(rps, 1)
        if em.doc["value"]:
            det["spmd_overhead_vs_plain"] = round(em.doc["value"] / rps, 3)
        _log(f"spmd 1-dev: {rps:.0f} reads/s "
             f"({det.get('spmd_overhead_vs_plain')}x plain)")

    em.run("spmd_overhead", 200, sec_spmd_overhead)

    tmp.cleanup()
    em.emit()
    if em.failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
