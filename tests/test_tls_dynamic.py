"""The paired pipeline must compile ONCE across learned TLS models.

Round-3 defect: TLS was a static jit argument, so every production run
(which re-learns a slightly different model) recompiled the whole paired
pipeline (~100 s measured).  The reference re-determines TLS every run at
zero compile cost (lib/alignment/MatchSelector.cpp:188-256); the device
design matches it by passing the TLS fields as traced int32 scalars and
quantizing the (shape-setting) rescue window to power-of-two buckets.
"""

import dataclasses

import numpy as np
import pytest

from isaac_aligner_tpu import aligner as aligner_mod
from isaac_aligner_tpu import dna
from isaac_aligner_tpu.align.pairs import TlsStatic, quantize_rescue_window
from isaac_aligner_tpu.aligner import PairedAligner
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu.io.fastq import batch_from_reads

READ_LEN = 64
GENOME_LEN = 20000


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(21)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, GENOME_LEN))
    genome = genome_from_sequences([("chrD", seq)])
    index = build_index(genome, seed_len=32)
    return genome, seq, index


def _make_pairs(seq, rng, n, drop_r1=()):
    names, r1s, r2s = [], [], []
    for i in range(n):
        p = int(rng.integers(0, GENOME_LEN - 1000))
        tlen = int(np.clip(rng.normal(300, 20), 150, 900))
        frag = seq[p : p + tlen]
        r1 = frag[:READ_LEN]
        if i in drop_r1:  # garbage end 1 -> shadow row exercises rescue
            r1 = "".join("ACGT"[j % 4] * 1 for j in range(READ_LEN))
        r2 = dna.decode(dna.revcomp(dna.encode(frag[-READ_LEN:])))
        names.append(f"d{i}")
        r1s.append(r1)
        r2s.append(r2)
    return batch_from_reads(names, r1s), batch_from_reads(names, r2s)


def test_quantize_rescue_window():
    assert quantize_rescue_window(1, 4096) == 256
    assert quantize_rescue_window(256, 4096) == 256
    assert quantize_rescue_window(257, 4096) == 512
    assert quantize_rescue_window(1025, 4096) == 2048
    # pow2 overshoots the cap but the span fits -> cap is the bucket
    assert quantize_rescue_window(3000, 4096) == 4096
    assert quantize_rescue_window(4097, 4096) == 8192  # disabled by caller


def test_paired_pipeline_compiles_once_across_tls(ref):
    """Two different learned TLS models (same window bucket) must share
    every executable: jit cache sizes stay at 1 after the second run."""
    genome, seq, index = ref
    rng = np.random.default_rng(5)
    al = PairedAligner.create(index, read_len=READ_LEN)

    tls_a = TlsStatic(min=240, max=360, mate_min=240, mate_max=360,
                      best0=1, best1=6, median=300)
    # a *different* learned model in the same quantized window bucket
    tls_b = TlsStatic(min=233, max=371, mate_min=233, mate_max=371,
                      best0=1, best1=0, median=302)
    assert al.max_rescue_window >= 512

    b1, b2 = _make_pairs(seq, rng, 64, drop_r1={3, 9})
    # deltas, not absolutes: other tests may share the module-level jit caches
    before = {
        "paired": aligner_mod._paired_packed_jit._cache_size(),
        "rescue": aligner_mod._rescue_jit._cache_size(),
    }
    results = []
    sizes = {}
    for tls in (tls_a, tls_b):
        al.tls = tls
        results.append(al.align_batch_arrays(b1, b2))
        if not sizes:
            sizes = {
                "paired": aligner_mod._paired_packed_jit._cache_size(),
                "rescue": aligner_mod._rescue_jit._cache_size(),
            }
    after = {
        "paired": aligner_mod._paired_packed_jit._cache_size(),
        "rescue": aligner_mod._rescue_jit._cache_size(),
    }
    # the decisive property: run 2 (different TLS values) added ZERO new
    # executables over run 1; and run 1 added at most one (zero when an
    # earlier test already compiled the same shapes)
    assert after["paired"] == sizes["paired"] <= before["paired"] + 1
    # rescue ran (shadow rows exist) and did not recompile
    assert after["rescue"] == sizes["rescue"] <= before["rescue"] + 1
    # and the model change actually reached the kernel: proper-pair flags
    # follow the active model set (tls_b swaps best1 to FFp)
    assert results[0]["pair_resolved"].sum() > 0


def test_tls_values_affect_results_without_recompile(ref):
    """Narrow vs wide TLS limits change proper_pair decisions through the
    SAME executable."""
    genome, seq, index = ref
    rng = np.random.default_rng(11)
    al = PairedAligner.create(index, read_len=READ_LEN)
    b1, b2 = _make_pairs(seq, rng, 32)

    al.tls = TlsStatic(min=250, max=350, mate_min=250, mate_max=350,
                       best0=1, best1=6, median=300)
    wide = al.align_batch_arrays(b1, b2)
    n0 = aligner_mod._paired_packed_jit._cache_size()
    # absurdly narrow window: nothing is a proper pair any more
    al.tls = TlsStatic(min=1, max=2, mate_min=1, mate_max=2,
                       best0=1, best1=6, median=1)
    narrow = al.align_batch_arrays(b1, b2)
    assert aligner_mod._paired_packed_jit._cache_size() == n0
    assert wide["proper_pair"].sum() > narrow["proper_pair"].sum()


def test_sharded_step_reused_across_tls(ref):
    """ShardedPairedAligner._ensure_step must key on the quantized window,
    not the TLS values."""
    from isaac_aligner_tpu.parallel.sharded_aligner import \
        ShardedPairedAligner

    genome, seq, index = ref
    al = ShardedPairedAligner.create_sharded(index, n_devices=2,
                                             read_len=READ_LEN)
    al.tls = TlsStatic(min=240, max=360, mate_min=240, mate_max=360,
                       best0=1, best1=6, median=300)
    step_a = al._ensure_step()
    al.tls = TlsStatic(min=200, max=390, mate_min=200, mate_max=390,
                       best0=1, best1=6, median=295)
    assert al._ensure_step() is step_a

    rng = np.random.default_rng(3)
    b1, b2 = _make_pairs(seq, rng, 16)
    res = al.align_batch_arrays(b1, b2)
    assert res["proper_pair"].sum() > 0


def test_mate_window_dynamic_matches_host_model():
    """The jnp window math must reproduce TemplateLengthStatistics'
    mateMin/MaxPosition + mateOrientation for every (model pair,
    read_index, orientation) combination."""
    from isaac_aligner_tpu.align.pairs import mate_window_dynamic

    read_lengths = (64, 72)
    for best0 in range(8):
        for best1 in range(8):
            tls = TlsStatic(min=150, max=420, mate_min=150, mate_max=420,
                            best0=best0, best1=best1, median=285)
            s = tls.to_stats()
            for read_index in (0, 1):
                rev = np.array([False, True])
                mn, mx, sr = mate_window_dynamic(tls, read_index,
                                                 read_lengths, rev)
                mn, mx, sr = np.asarray(mn), np.asarray(mx), np.asarray(sr)
                for j, r in enumerate((False, True)):
                    assert mn[j] == s.mate_min_position(
                        read_index, r, 0, read_lengths), \
                        (best0, best1, read_index, r)
                    assert mx[j] == s.mate_max_position(
                        read_index, r, 0, read_lengths)
                    assert bool(sr[j]) == s.mate_orientation(read_index, r)
