"""Banded Smith-Waterman vs the numpy oracle and known CIGARs."""

import numpy as np
import pytest

from isaac_aligner_tpu import dna
from isaac_aligner_tpu.ops import sw


def _codes(s):
    return dna.encode(s)


def _align_one(query, db, scores=sw.BWA_SCORES):
    """Helper: run the DP on one pair, return (score, cigar, first_db)."""
    g, tb = sw.banded_sw(np.asarray([query]), np.asarray([db]), scores)
    g = np.asarray(g)[0]
    tb = np.asarray(tb)[0]
    exit_d = int(np.argmax(g))
    ops, first_db = sw.traceback(tb, exit_d, len(query))
    return float(g[exit_d]), sw.ops_to_cigar(ops), first_db


def _window_for(ref, pos, read_len):
    """BAND-1 extra bases, split 7 left / 8 right like reference getFlanks."""
    left = min(7, pos)
    db = ref[pos - left : pos - left + read_len + sw.BAND - 1]
    return db, left


def test_kernel_matches_numpy_oracle_random():
    rng = np.random.default_rng(0)
    n, l = 16, 40
    q = rng.integers(0, 4, (n, l)).astype(np.int32)
    db = rng.integers(0, 4, (n, l + sw.BAND - 1)).astype(np.int32)
    g, tb = sw.banded_sw(q, db)
    g = np.asarray(g)
    tb = np.asarray(tb)
    for i in range(n):
        g_ref, tb_ref = sw.banded_sw_numpy(q[i], db[i])
        np.testing.assert_allclose(g[i], g_ref, rtol=0, atol=1e-3,
                                   err_msg=f"pair {i}")
        np.testing.assert_array_equal(tb[i], tb_ref, err_msg=f"pair {i}")


def test_perfect_match_cigar():
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 4, 200).astype(np.int32)
    read = ref[50:90].copy()
    db, left = _window_for(ref, 50, 40)
    score, cigar, first_db = _align_one(read, db)
    assert cigar == [(40, "M")]
    assert first_db == left  # alignment starts exactly at pos
    assert score == 0.0      # bwa scoring: match == 0


def test_deletion_cigar():
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 300).astype(np.int32)
    # read = ref[100:120] + ref[125:145]  (5-base deletion in read)
    read = np.concatenate([ref[100:120], ref[125:145]])
    db, left = _window_for(ref, 100, 40)
    score, cigar, first_db = _align_one(read, db)
    assert cigar == [(20, "M"), (5, "D"), (20, "M")], cigar
    assert first_db == left
    # bwa: open -11, extend -4 per extra base
    assert score == -11 - 4 * 4


def test_insertion_cigar():
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 300).astype(np.int32)
    # read has 3 inserted bases after 18 matched
    ins = rng.integers(0, 4, 3)
    read = np.concatenate([ref[100:118], ins, ref[118:137]])  # 40 bases
    db, left = _window_for(ref, 100, 40)
    score, cigar, first_db = _align_one(read, db)
    # insertion content may accidentally match; accept either exact cigar
    # or a higher-scoring equivalent, but the common case is clean:
    if cigar == [(18, "M"), (3, "I"), (19, "M")]:
        assert score == -11 - 4 * 2
    else:
        # whatever the kernel chose must score at least as well
        assert score >= -11 - 4 * 2


def test_mismatches_no_gap():
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 300).astype(np.int32)
    read = ref[60:100].copy()
    read[10] = (read[10] + 1) % 4
    read[30] = (read[30] + 2) % 4
    db, left = _window_for(ref, 60, 40)
    score, cigar, first_db = _align_one(read, db)
    assert cigar == [(40, "M")]
    assert score == -3 * 2


def test_eland_scoring_variant():
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 300).astype(np.int32)
    read = ref[30:70].copy()
    db, left = _window_for(ref, 30, 40)
    score, cigar, _ = _align_one(read, db, scores=sw.ELAND_SCORES)
    assert cigar == [(40, "M")]
    assert score == 2.0 * 40


def _polish_like_batch(rng, n, l):
    """Pairs shaped like polish_gapped's: half are reads taken from their
    window with an indel and substitutions, half random; codes include N."""
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
    db[db == 3] = np.where(rng.random((db == 3).sum()) < 0.02, 4, 3)
    return q, db


@pytest.mark.parametrize("n", [1, 300, 512])
@pytest.mark.parametrize("scores", [sw.BWA_SCORES, sw.ELAND_SCORES],
                         ids=["bwa", "eland"])
@pytest.mark.parametrize("l", [100, 150])
def test_banded_sw_exact_vs_batch_oracle(l, scores, n):
    """The jitted DP equals the vectorized host oracle bit for bit on
    final scores and packed traceback, at polish_gapped's shapes."""
    q, db = _polish_like_batch(np.random.default_rng(l * 7 + n), n, l)
    g, tb = sw.banded_sw_jit(q, db, scores)
    g_ref, tb_ref = sw.banded_sw_numpy_batch(q, db, scores)
    np.testing.assert_array_equal(np.asarray(g), g_ref)
    np.testing.assert_array_equal(np.asarray(tb), tb_ref)


def test_banded_sw_partial_pack_group():
    """L not a multiple of TB_PACK: the tail rows pack into a last,
    partly filled word."""
    q, db = _polish_like_batch(np.random.default_rng(9), 64, 42)
    g, tb = sw.banded_sw_jit(q, db)
    g_ref, tb_ref = sw.banded_sw_numpy_batch(q, db)
    assert np.asarray(tb).shape == (64, 9, sw.BAND)
    np.testing.assert_array_equal(np.asarray(g), g_ref)
    np.testing.assert_array_equal(np.asarray(tb), tb_ref)


@pytest.mark.gpu
def test_banded_sw_on_gpu_matches_oracle(gpu_device):
    """Compiled for the card at polish_gapped's block, exact vs oracle."""
    import jax
    q, db = _polish_like_batch(np.random.default_rng(1), 512, 150)
    g, tb = jax.device_get(sw.banded_sw_jit(
        jax.device_put(q, gpu_device), jax.device_put(db, gpu_device)))
    g_ref, tb_ref = sw.banded_sw_numpy_batch(q, db)
    np.testing.assert_array_equal(g, g_ref)
    np.testing.assert_array_equal(tb, tb_ref)
