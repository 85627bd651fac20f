"""Alignment-quality math: per-base log-probability tables and MAPQ.

Reference parity targets:
- log-prob lookup tables: reference src/c++/lib/alignment/Quality.cpp
  (getLogMatchLookup / getLogMismatchLookup).  Q0 is treated as Q1 in BOTH
  tables ("Ns in data come in Q0 from Bcl"), and — exactly as in the
  reference — logMismatchLookup[0] equals log(1 - 10^-0.1), i.e. the
  MATCH probability at Q1, not a mismatch probability.
- match definition: reference src/c++/include/alignment/Alignment.hh:44
  isMatch(read, ref) = read=='n' || (read==ref && ref!='N'): an N read
  base *matches* for probability purposes, while edit distance counts it.
- rest-of-genome correction 2*G/4^L: reference
  src/c++/include/alignment/Quality.hh (restOfGenomeCorrection).
- MAPQ: floor(-10*log10(pNeighborhood / (pNeighborhood + pBest)))
  (reference TemplateBuilder::updateMappingScore,
  src/c++/lib/alignment/TemplateBuilder.cpp:233-286).

Tables are float32 on device; the reference uses float64.  The absolute
log-prob scale here (~1e-3..1e1 per base over <=250 bases) keeps float32
error around 1e-4, well inside the reference's own ISAAC_LP_EQUALS
epsilon (1e-7 is the tie-break epsilon, but a MAPQ unit is ~0.1 in log10
space), so floor() boundaries move only for near-exact ties.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

MAX_Q = 100


def _log_match_table() -> np.ndarray:
    t = np.empty(MAX_Q, dtype=np.float64)
    t[0] = np.log(1.0 - 10.0 ** (-0.1))
    for q in range(1, MAX_Q):
        t[q] = np.log(1.0 - 10.0 ** (-q / 10.0))
    return t


def _log_mismatch_table() -> np.ndarray:
    t = np.empty(MAX_Q, dtype=np.float64)
    t[0] = np.log(1.0 - 10.0 ** (-0.1))  # sic — see module docstring
    for q in range(1, MAX_Q):
        t[q] = np.log(10.0 ** (-q / 10.0) / 3.0)
    return t


LOG_MATCH_F64 = _log_match_table()
LOG_MISMATCH_F64 = _log_mismatch_table()

# numpy at module level (importing must never initialize a JAX backend);
# traced code uses log_tables() which converts lazily per trace
LOG_MATCH_NP = LOG_MATCH_F64.astype(np.float32)
LOG_MISMATCH_NP = LOG_MISMATCH_F64.astype(np.float32)

# backwards-compatible aliases for host-side (numpy) indexing
LOG_MATCH = LOG_MATCH_NP
LOG_MISMATCH = LOG_MISMATCH_NP


def log_tables() -> tuple[jnp.ndarray, jnp.ndarray]:
    """jnp views of the per-quality log-prob tables (call inside traces)."""
    return jnp.asarray(LOG_MATCH_NP), jnp.asarray(LOG_MISMATCH_NP)


def rest_of_genome_correction(genome_length: int, read_length: int) -> float:
    """P(best alignment is elsewhere in the genome) prior: 2*G/4^L."""
    return float(np.exp(np.log(2.0) + np.log(float(genome_length))
                        - np.log(4.0) * float(read_length)))


def log_rest_of_genome_correction(genome_length: int, read_length: int) -> float:
    """ln of the rest-of-genome prior — usable where 2*G/4^L itself
    underflows f32 (rescued-pair scoring works entirely in log space)."""
    return float(np.log(2.0) + np.log(float(genome_length))
                 - np.log(4.0) * float(read_length))


def mapping_quality(best_log_prob, others_prob_sum, rog_correction):
    """MAPQ from the best candidate's probability vs the neighborhood.

    All args broadcastable jnp arrays; returns float (caller floors/casts).
    neighborhood = rog + sum(exp(lp_i) for non-best candidates)
    mapq = -10*log10(neighborhood / (neighborhood + exp(best_lp)))

    NOTE: raw exp() here underflows float32 for log probs below ~-87
    (high-mismatch placements) and rog underflows for reads past ~60bp
    on small genomes; the device paths use the *_scaled variants below
    and HOST callers must use mapping_quality_f64 — jnp silently
    downcasts float64 to float32 with x64 disabled.
    """
    neighborhood = rog_correction + others_prob_sum
    p_best = jnp.exp(best_log_prob)
    frac = neighborhood / (neighborhood + p_best)
    # frac in (0,1]; guard the log for frac==0 (cannot happen with rog>0)
    return -10.0 * jnp.log10(jnp.maximum(frac, 1e-38))


def mapping_quality_f64(best_log_prob, others_prob_sum, rog_correction):
    """Host float64 mapping_quality (numpy end to end — the jnp form
    would downcast f64 inputs to f32 under the default x64=off config,
    turning small-rog / very-negative-lp rows into 0/0 NaNs)."""
    nb = np.asarray(rog_correction, np.float64) \
        + np.asarray(others_prob_sum, np.float64)
    p_best = np.exp(np.asarray(best_log_prob, np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = nb / (nb + p_best)
        out = -10.0 * np.log10(np.maximum(frac, 1e-300))
    # nb == p_best == 0 (no mass at all) -> maximal confidence is wrong;
    # callers gate on aligned, return 0 for definiteness
    return np.where(np.isfinite(out), out, 0.0)


# -- float32-safe scaled-exponential forms -----------------------------------
# The reference computes all probability-mass sums in C++ double
# (TemplateBuilder::updateMappingScore, TemplateBuilder.cpp:233-286); the
# device pipeline runs in float32, so its kernels scale every mass by
# exp(-m) with m the row-max log prob — the same trick the rescue kernel
# has always used — which keeps the ratios exact in float32 where the raw
# exponentials underflow (found by the paired f64 parity oracle: a
# 20-mismatch end has lp ~ -156, exp underflows, and the template score
# collapsed to 0 where the double math gives 52).

def scaled_masses(lp, valid, best_lp):
    """(total_scaled, p_best_scaled, m_safe): probability masses scaled
    by exp(-m), m = per-row max of the valid log probs (last axis)."""
    m = jnp.max(jnp.where(valid, lp, -jnp.inf), axis=-1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    total = jnp.sum(jnp.where(valid, jnp.exp(lp - m_safe[..., None]), 0.0),
                    axis=-1)
    p_best = jnp.where(jnp.isfinite(best_lp) & jnp.isfinite(m),
                       jnp.exp(best_lp - m_safe), 0.0)
    return total, p_best, m_safe


def rog_scaled(log_rog, m_safe):
    """The rest-of-genome prior on the exp(-m) scale; the clip bounds the
    exponent to the f32-representable band (outside it the score is far
    beyond the MAPQ cap either way)."""
    return jnp.exp(jnp.clip(jnp.float32(log_rog) - m_safe, -87.0, 88.0))


def mapping_quality_scaled(total_scaled, p_best_scaled, rog_s):
    """mapping_quality over exp(-m)-scaled masses (scale cancels in the
    ratio)."""
    nb = jnp.maximum(total_scaled - p_best_scaled, 0.0) + rog_s
    frac = nb / jnp.maximum(nb + p_best_scaled, 1e-38)
    return -10.0 * jnp.log10(jnp.maximum(frac, 1e-38))
