"""Vectorized branchless binary search over sorted multi-word key planes.

This replaces the reference's disk-streamed sorted merge-join
(ExactMaskMatcher, src/c++/lib/alignment/matchFinder/ExactMaskMatcher.cpp:83-210)
with a data-parallel formulation: every query seed binary-searches the
device-resident sorted index with a fixed number of gather steps
(ceil(log2(N))+1 probes), fully data-parallel across all seeds of a batch.

Composite keys are held as int32 planes (no int64 on the device) and
compared lexicographically: two planes for 16/32-mers (hi, lo), four for
the 64-mer LongKmerType index (hi, mid1, mid2, lo — reference
include/oligo/Kmer.hh:32-38 uses __uint128).  The power-of-two stepping
search is branch-free: each step is one gather per plane + compare +
select over the whole query vector, so the loop is log-depth with full
VPU lanes busy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalar, NOT jnp: a module-level jnp constant would initialize
# the XLA backend at import time, which breaks jax.distributed.initialize
# (multi-host must init before any backend use)
I32_MAX = np.int32(2**31 - 1)


def _lex_lt_n(words, q_words):
    """Lexicographic <, outermost word first; words/q_words same length."""
    r = words[-1] < q_words[-1]
    for w, q in zip(reversed(words[:-1]), reversed(q_words[:-1])):
        r = (w < q) | ((w == q) & r)
    return r


def _lex_le_n(words, q_words):
    r = words[-1] <= q_words[-1]
    for w, q in zip(reversed(words[:-1]), reversed(q_words[:-1])):
        r = (w < q) | ((w == q) & r)
    return r


def pad_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _count_prefix(planes, pred, out_shape):
    """Number of leading records satisfying `pred` (pred true on a prefix).

    `planes` is a tuple of same-length sorted key planes; `pred` receives
    the tuple of gathered probe words.  Branch-free stepping: step sizes
    n, n/2, ..., 1 guarantee any answer in [0, n] is reachable; probes
    are clamped in-range and guarded so out-of-range steps never fire.
    """
    n_pad = planes[0].shape[0]
    assert n_pad & (n_pad - 1) == 0, "key planes must be padded to a power of two"
    pos = jnp.zeros(out_shape, jnp.int32)
    step = n_pad
    while step >= 1:
        probe = jnp.minimum(pos + step - 1, n_pad - 1)
        ok = (pos + step <= n_pad) & pred(tuple(p[probe] for p in planes))
        pos = jnp.where(ok, pos + step, pos)
        step //= 2
    return pos


def _key_tuples(key_hi, key_lo, q_hi, q_lo, key_mids, q_mids):
    """(planes, query words) in outer->inner comparison order."""
    return (key_hi, *key_mids, key_lo), (q_hi, *q_mids, q_lo)


def sorted_range(key_hi, key_lo, q_hi, q_lo, n_real,
                 key_mids=(), q_mids=()):
    """Find the match range of each query key in the sorted key planes.

    Planes must be padded to a power-of-two length with I32_MAX
    sentinels.  `n_real` is the count of real records; the returned range
    is clamped to it so sentinel padding can never be reported as a match
    (relevant for the all-T k-mer whose biased key equals the sentinel).
    `key_mids`/`q_mids` carry the two middle words of 64-mer keys
    (empty for 16/32-mers).

    Returns (begin, count) int32 arrays with the query shape.
    """
    planes, qs = _key_tuples(key_hi, key_lo, q_hi, q_lo, key_mids, q_mids)
    lower = _count_prefix(planes, lambda ws: _lex_lt_n(ws, qs), jnp.shape(q_hi))
    upper = _count_prefix(planes, lambda ws: _lex_le_n(ws, qs), jnp.shape(q_hi))
    lower = jnp.minimum(lower, n_real)
    upper = jnp.minimum(upper, n_real)
    return lower, upper - lower


def _count_prefix_bounded(planes, pred, lo, hi, start_step: int):
    """Like _count_prefix but searching only [lo, hi) per query, with a
    static power-of-two step schedule starting at start_step.  Requires
    start_step >= (hi - lo) for every query."""
    n_pad = planes[0].shape[0]
    pos = lo
    step = start_step
    while step >= 1:
        probe = jnp.minimum(pos + step - 1, n_pad - 1)
        ok = (pos + step <= hi) & pred(tuple(p[probe] for p in planes))
        pos = jnp.where(ok, pos + step, pos)
        step //= 2
    return pos


def sorted_range_bucketed(key_hi, key_lo, q_hi, q_lo, n_real, bucket_starts,
                          width: int, bucket_log2: int,
                          count_cap_log2: int | None = None,
                          key_mids=(), q_mids=()):
    """sorted_range accelerated by a first-level prefix-bucket table.

    This is the device form of the reference's maskWidth sharding
    (oligo::Mask, src/c++/include/oligo/Mask.hh:36; 2^maskWidth sorted
    shard files): `bucket_starts` [2^width + 1] maps each key's top
    `width` bits to its record range, so the per-query binary search runs
    only over one bucket — `bucket_log2`+1 probe steps instead of
    log2(N)+1.  `bucket_log2` must satisfy 2^bucket_log2 >= the largest
    bucket (host-computed at index prep; see pipeline.build_bucket_table).

    When `count_cap_log2` is given, the upper bound is only resolved
    within [lower, lower + 2^count_cap_log2]: the returned count saturates
    at 2^count_cap_log2.  Callers that only need "count <= threshold vs
    too many" (repeat_threshold semantics) pass a cap just above the
    threshold and save the full-depth second search.
    """
    planes, qs = _key_tuples(key_hi, key_lo, q_hi, q_lo, key_mids, q_mids)
    qu = jax.lax.bitcast_convert_type(q_hi, jnp.uint32) ^ jnp.uint32(1 << 31)
    bucket = (qu >> jnp.uint32(32 - width)).astype(jnp.int32)
    lo = bucket_starts[bucket]
    hi = bucket_starts[bucket + 1]
    start_step = 1 << bucket_log2
    lower = _count_prefix_bounded(
        planes, lambda ws: _lex_lt_n(ws, qs), lo, hi, start_step)
    if count_cap_log2 is not None and count_cap_log2 < bucket_log2:
        hi = jnp.minimum(hi, lower + (1 << count_cap_log2))
        upper = _count_prefix_bounded(
            planes, lambda ws: _lex_le_n(ws, qs), lower, hi,
            1 << count_cap_log2)
    else:
        upper = _count_prefix_bounded(
            planes, lambda ws: _lex_le_n(ws, qs), lo, hi, start_step)
    lower = jnp.minimum(lower, n_real)
    upper = jnp.minimum(upper, n_real)
    return lower, upper - lower


def sorted_prefix_range(key_hi, key_lo, q_hi, n_real):
    """Match range of each query's HIGH word alone (the 16-base prefix
    block of the reference's NeighborMaskMatcher,
    lib/alignment/matchFinder/NeighborMaskMatcher.cpp:44-268).

    Returns (begin, count) of all records whose key_hi equals q_hi,
    regardless of key_lo.
    """
    planes = (key_hi, key_lo)
    lower = _count_prefix(planes, lambda ws: ws[0] < q_hi, jnp.shape(q_hi))
    upper = _count_prefix(planes, lambda ws: ws[0] <= q_hi, jnp.shape(q_hi))
    lower = jnp.minimum(lower, n_real)
    upper = jnp.minimum(upper, n_real)
    return lower, upper - lower
