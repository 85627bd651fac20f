"""Banded Smith-Waterman: a batched `lax` DP + numpy oracle.

Reference analog: the SSE2 BandedSmithWaterman
(src/c++/include/alignment/BandedSmithWaterman.hh:50-108,
 src/c++/lib/alignment/BandedSmithWaterman.cpp) — an ELAND-derived
affine-gap aligner over a BAND of 16 diagonals: the query (read) is fully
consumed, the database window is query_len + 15 reference bases, and the
leading/trailing window offset is free (folded into the alignment start
position, GappedAligner.cpp:180-250).

Design (not a SIMD translation):
- PAIRS are the minor (vector) axis: the DP state is [BAND, N], so every
  element-wise op covers all alignments of the batch at once, and XLA
  fuses each row's recurrences.
- The in-row E recurrence (gap in the query consuming database bases,
  E[d] = max(A[d-1], E[d-1]+extend)) is solved with a prefix max
  (`lax.cummax`) over the band axis instead of the reference's 16-step
  scalar loop.
- `lax.scan` runs over groups of TB_PACK query rows; each step unrolls
  its rows and emits one packed traceback word per band cell, so the
  traceback plane is [ceil(L/TB_PACK), BAND, N] int32 (2 bits per state,
  3 states per row, TB_PACK rows per word).  The walk itself is cheap
  and runs vectorized on the host (align/gapped.py).

Band coordinates: cell (i, d) aligns query base i against database
position i + d, d in [0, 16).  Recurrences:
  G[i,d] = max(G,E,F)[i-1,d] + W(q_i, db_{i+d})        (diagonal)
  F[i,d] = max(G[i-1,d+1]-open, E[i-1,d+1]-open, F[i-1,d+1]-extend)
           (insertion: query base consumed, database not)
  E[i,d] = max(G[i,d-1]-open, F[i,d-1]-open, E[i,d-1]-extend)
           (deletion: database base consumed, query not)
Row 0 enters free at any d (G[0,d] = W[0,d]).  Final score =
max_d G[L-1,d]; the exit/entry offsets give the position adjustment.
State preference on ties is G > E > F, matching the reference's
comparison order (BandedSmithWaterman.cpp:140-190).

Scores are float32 sums of small integers, so the DP is exact and
bit-identical to the numpy oracle below on every backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BAND = 16
NEG = -1.0e9
#: query rows packed per traceback word (6 bits of state codes per row)
TB_PACK = 5

# default scores: the reference's default --gap-scoring "bwa" preset
# 0:-3:-11:-4:-20 (AlignOptions.cpp:55,124)
BWA_SCORES = (0.0, -3.0, -11.0, -4.0)       # match, mismatch, open, extend
ELAND_SCORES = (2.0, -1.0, -15.0, -3.0)


def _tie_code(a, b, c):
    """State code of max(a, b, c) with the G > E > F tie preference
    (a = G-, b = E-, c = F-predecessor): 0, 1 or 2."""
    return jnp.where(b > jnp.maximum(a, c), 1, jnp.where(c > a, 2, 0))


def _row(scores, carry, w):
    """One query row of the banded DP on [BAND, N] state.

    Returns the new (G, E, F) carry and the row's 6-bit state codes
    (TG + 4*TE + 16*TF) [BAND, N] int32."""
    _match, _mismatch, open_s, extend_s = scores
    g_prev, e_prev, f_prev = carry
    fill = jnp.full((1, g_prev.shape[1]), NEG, jnp.float32)

    def up(x):                       # out[d] = x[d+1]; out[BAND-1] = NEG
        return jnp.concatenate([x[1:], fill], axis=0)

    def down(x):                     # out[d] = x[d-1]; out[0] = NEG
        return jnp.concatenate([fill, x[:-1]], axis=0)

    # diagonal: predecessor state max with G>E>F tie preference
    tg = _tie_code(g_prev, e_prev, f_prev)
    new_g = jnp.maximum(jnp.maximum(g_prev, e_prev), f_prev) + w

    # F: from row i-1, band d+1
    from_g = up(g_prev) + open_s
    from_e = up(e_prev) + open_s
    from_f = up(f_prev) + extend_s
    new_f = jnp.maximum(jnp.maximum(from_g, from_e), from_f)
    tf = _tie_code(from_g, from_e, from_f)

    # E: prefix max over d of A[k] - k*ext, then E[d] = P[d-1] + (d-1)*ext
    a_g = new_g + open_s
    a_f = new_f + open_s
    d_idx = jax.lax.broadcasted_iota(jnp.float32, new_g.shape, 0)
    pm = jax.lax.cummax(jnp.maximum(a_g, a_f) - d_idx * extend_s, axis=0)
    new_e = jnp.maximum(down(pm) + (d_idx - 1.0) * extend_s, NEG)
    # TE from the direct one-step recurrence (equivalent to the scan)
    te = _tie_code(down(a_g), down(new_e) + extend_s, down(a_f))
    return (new_g, new_e, new_f), tg + te * 4 + tf * 16


def banded_sw(query: jax.Array, db: jax.Array,
              scores: tuple[float, float, float, float] = BWA_SCORES):
    """Score a batch of banded alignments.

    Args:
      query: int32/uint8 [N, L] read codes (0..4).
      db:    int32/uint8 [N, L + BAND - 1] reference window codes.
      scores: (match, mismatch, gap_open, gap_extend), all "reward" signed.

    Returns:
      final_g: float32 [N, BAND] last-row G scores (alignment must end at
        query row L-1, band offset d; best = argmax).
      tb: int32 [N, ceil(L/TB_PACK), BAND] PACKED traceback codes — the
        6-bit code (TG + 4*TE + 16*TF, each 0=G 1=E 2=F) of query row i
        lives at word i // TB_PACK, bit offset 6 * (i % TB_PACK).
        Unpack with `unpack_tb`.
    """
    n, l = query.shape
    assert db.shape == (n, l + BAND - 1), (query.shape, db.shape)
    match_s, mismatch_s, open_s, extend_s = (np.float32(s) for s in scores)
    q = query.T.astype(jnp.int32)[:, None, :]                 # [L, 1, N]
    win = np.arange(l)[:, None] + np.arange(BAND)[None, :]    # [L, BAND]
    dbw = db.T.astype(jnp.int32)[win]                         # [L, BAND, N]
    w = jnp.where((dbw == q) & (q < 4), match_s, mismatch_s)
    sc = (match_s, mismatch_s, open_s, extend_s)

    def rows(carry, w_rows):
        word = jnp.zeros((BAND, n), jnp.int32)
        for r in range(w_rows.shape[0]):
            carry, code = _row(sc, carry, w_rows[r])
            word = word | (code << (6 * r))
        return carry, word

    # row-0 entry: free start at any band offset => diagonal predecessor 0
    carry = (jnp.zeros((BAND, n), jnp.float32),
             jnp.full((BAND, n), NEG, jnp.float32),
             jnp.full((BAND, n), NEG, jnp.float32))
    full = l // TB_PACK
    carry, words = jax.lax.scan(
        rows, carry, w[: full * TB_PACK].reshape(full, TB_PACK, BAND, n))
    if l % TB_PACK:
        carry, tail = rows(carry, w[full * TB_PACK:])
        words = jnp.concatenate([words, tail[None]], axis=0)
    return carry[0].T, jnp.transpose(words, (2, 0, 1))


@functools.partial(jax.jit, static_argnames=("scores",))
def banded_sw_jit(query, db, scores=BWA_SCORES):
    """Jitted `banded_sw`: the gather and transposes around the scan
    compile into the same program."""
    return banded_sw(query, db, scores=scores)


def unpack_tb(tb_packed: np.ndarray, l: int) -> np.ndarray:
    """Packed [.., ceil(L/TB_PACK), BAND] traceback words -> per-row 6-bit
    codes [.., L, BAND] (vectorized host unpack)."""
    tb_packed = np.asarray(tb_packed)
    rows = np.arange(l)
    words = tb_packed[..., rows // TB_PACK, :]
    shifts = (6 * (rows % TB_PACK))[..., :, None]
    return (words >> shifts) & 63


# ---------------------------------------------------------------------------
# numpy oracle (direct transcription of the recurrences; test-only)
# ---------------------------------------------------------------------------

def pack_tb(tb_rows: np.ndarray) -> np.ndarray:
    """Per-row codes [L, BAND] -> packed words [ceil(L/TB_PACK), BAND]."""
    l, band = tb_rows.shape
    groups = -(-l // TB_PACK)
    out = np.zeros((groups, band), np.int32)
    for i in range(l):
        out[i // TB_PACK] |= tb_rows[i] << (6 * (i % TB_PACK))
    return out


def banded_sw_numpy(query: np.ndarray, db: np.ndarray,
                    scores=BWA_SCORES):
    """Single-pair oracle returning (final_g [BAND],
    tb [ceil(L/TB_PACK), BAND] packed like the kernel's).

    float32 like the kernel so sentinel-region tie-breaks agree exactly
    (at -1e9, f32 swallows the gap-score differences; those cells are
    unreachable by any real traceback either way).
    """
    match_s, mismatch_s, open_s, extend_s = (np.float32(s) for s in scores)
    l = query.shape[0]
    g = np.zeros(BAND, np.float32)
    e = np.full(BAND, NEG, np.float32)
    f = np.full(BAND, NEG, np.float32)
    tb = np.zeros((l, BAND), np.int32)
    for i in range(l):
        w = np.array([match_s if (query[i] == db[i + d] and query[i] < 4)
                      else mismatch_s for d in range(BAND)], np.float32)
        m_prev = np.maximum(np.maximum(g, e), f)
        tg = np.where(e > np.maximum(g, f), 1, np.where(f > g, 2, 0))
        new_g = m_prev + w
        up = lambda x: np.concatenate([x[1:], [np.float32(NEG)]]).astype(np.float32)
        fg, fe, ff = up(g) + open_s, up(e) + open_s, up(f) + extend_s
        new_f = np.maximum(np.maximum(fg, fe), ff)
        tf = np.where(fe > np.maximum(fg, ff), 1, np.where(ff > fg, 2, 0))
        new_e = np.full(BAND, NEG, np.float32)
        te = np.zeros(BAND, np.int32)
        for d in range(1, BAND):
            fg2 = new_g[d - 1] + open_s
            ff2 = new_f[d - 1] + open_s
            fe2 = new_e[d - 1] + extend_s
            new_e[d] = max(fg2, ff2, fe2)
            te[d] = 1 if fe2 > max(fg2, ff2) else (2 if ff2 > fg2 else 0)
        tb[i] = tg + te * 4 + tf * 16
        g, e, f = new_g, new_e, new_f
    return g, pack_tb(tb)


def banded_sw_numpy_batch(queries: np.ndarray, dbs: np.ndarray,
                          scores=BWA_SCORES):
    """Vectorized host DP over a batch of pairs: queries [N, L] int,
    dbs [N, L+BAND-1] int -> (g [N, BAND], tb [N, ceil(L/TB_PACK), BAND]).

    Bit-identical to `banded_sw_numpy` row by row (all elementwise f32
    ops; no accumulation-order hazards), but loops only over L x BAND
    with [N]-vector numpy ops — the per-row Python version costs ~5 ms
    of GIL-held loop per pair, which starved the 2-core e2e pipeline
    when the gapped polish ran on finish workers (round-5 profile)."""
    match_s, mismatch_s, open_s, extend_s = (np.float32(s) for s in scores)
    neg = np.float32(NEG)
    n, l = queries.shape
    g = np.zeros((n, BAND), np.float32)
    e = np.full((n, BAND), neg, np.float32)
    f = np.full((n, BAND), neg, np.float32)
    tb = np.zeros((n, l, BAND), np.int32)
    up_fill = np.full((n, 1), neg, np.float32)

    def up(x):
        return np.concatenate([x[:, 1:], up_fill], axis=1)

    for i in range(l):
        q_i = queries[:, i : i + 1]
        w = np.where((q_i == dbs[:, i : i + BAND]) & (q_i < 4),
                     match_s, mismatch_s)
        m_prev = np.maximum(np.maximum(g, e), f)
        tg = np.where(e > np.maximum(g, f), 1, np.where(f > g, 2, 0))
        new_g = m_prev + w
        fg, fe, ff = up(g) + open_s, up(e) + open_s, up(f) + extend_s
        new_f = np.maximum(np.maximum(fg, fe), ff)
        tf = np.where(fe > np.maximum(fg, ff), 1, np.where(ff > fg, 2, 0))
        new_e = np.full((n, BAND), neg, np.float32)
        te = np.zeros((n, BAND), np.int32)
        for d in range(1, BAND):
            fg2 = new_g[:, d - 1] + open_s
            ff2 = new_f[:, d - 1] + open_s
            fe2 = new_e[:, d - 1] + extend_s
            new_e[:, d] = np.maximum(np.maximum(fg2, ff2), fe2)
            te[:, d] = np.where(fe2 > np.maximum(fg2, ff2), 1,
                                np.where(ff2 > fg2, 2, 0))
        tb[:, i] = tg + te * 4 + tf * 16
        g, e, f = new_g, new_e, new_f

    # pack TB_PACK query rows per int32 word (pack_tb, batched)
    groups = -(-l // TB_PACK)
    pad = groups * TB_PACK - l
    if pad:
        tb = np.concatenate(
            [tb, np.zeros((n, pad, BAND), np.int32)], axis=1)
    tb = tb.reshape(n, groups, TB_PACK, BAND)
    shifts = (6 * np.arange(TB_PACK, dtype=np.int32))[None, None, :, None]
    packed = np.bitwise_or.reduce(tb << shifts, axis=2)
    return g, packed


def traceback(tb_packed: np.ndarray, exit_d: int, l: int | None = None):
    """Walk one PACKED traceback matrix from (L-1, exit_d) in state G.

    Returns (ops, first_db) where ops is the list of CIGAR ops
    'M','I','D' in query order and first_db the window-relative index of
    the first database base the alignment consumes (= position offset
    inside the window; the caller adds it to the window start).
    """
    if l is None:
        l = tb_packed.shape[0] * TB_PACK   # exact when L % TB_PACK == 0
    tb = unpack_tb(tb_packed, l)
    i, d, state = l - 1, int(exit_d), 0
    ops: list[str] = []
    first_db = 0
    while i >= 0:
        code = tb[i, d]
        if state == 0:       # G: consumed q_i vs db_{i+d}
            ops.append("M")
            first_db = i + d
            state = code & 3
            i -= 1
        elif state == 1:     # E: deletion, consumed db_{i+d} only
            ops.append("D")
            first_db = i + d
            state = (code >> 2) & 3
            d -= 1
        else:                # F: insertion, consumed query only
            ops.append("I")
            state = (code >> 4) & 3
            i -= 1
            d += 1
    ops.reverse()
    return ops, first_db


def ops_to_cigar(ops: list[str]) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out
