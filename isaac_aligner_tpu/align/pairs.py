"""Paired-end resolution on device: pair cross-product scoring, template
MAPQ, and TLS-window shadow rescue.

Reference analog: TemplateBuilder (src/c++/lib/alignment/TemplateBuilder.cpp):
locateBestPair (:287) scans the candidate cross-product for pairs matching
the TLS model and accumulates total pair probability; buildPairedEndTemplate
(:398) computes the template alignment score
  floor(-10*log10((totalProb - pBest + rog) / (totalProb + rog)))
and proper-pair flag; rescueShadow (:495) + ShadowAligner searches the
TLS-implied window for the missing mate.

Device re-design:
- the pair search is a dense [B, C, C] tensor op over the two ends'
  candidate lists (C = max_candidates) instead of a per-cluster nested
  loop — model id, template length, match mask, probability sums and the
  lexicographic (pair SW score, -logProb) argmin are all vectorized.
- shadow rescue scores EVERY offset of the TLS window with the vectorized
  ungapped scorer (a brute-force scan is MXU/VPU-friendly and strictly
  more sensitive than the reference's 7-mer-hash candidate heuristic,
  ShadowAligner.cpp:74-294); it runs as a separate fixed-capacity batch
  over host-compacted orphan rows so the cost is paid only for orphans.
- TLS parameters enter as a DYNAMIC pytree of int32 scalars (TlsStatic is
  registered with jax.tree_util.register_dataclass): the paired pipeline
  compiles ONCE and every learned model reuses the executable.  The
  reference re-determines TLS every run at zero compile cost
  (MatchSelector.cpp:188-256); only the rescue-window SIZE is shape-
  setting and stays a static arg, quantized to power-of-two buckets by
  the host driver so at most ~5 executables ever exist.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna
from ..ops import bitops
from . import quality
from .pipeline import AlignConfig, IndexArrays, scatter_hash
from .tls import TEMPLATE_LENGTH_THRESHOLD, TemplateLengthStatistics


@dataclasses.dataclass(frozen=True)
class TlsStatic:
    """TLS snapshot.  Registered as a pytree (all fields are leaves), so
    passing it to a jitted kernel traces the fields as int32 scalars —
    a changed learned model NEVER recompiles the paired pipeline.  On the
    host the fields are plain ints and the window/model helpers below
    operate on them directly."""

    min: int = 0
    max: int = TEMPLATE_LENGTH_THRESHOLD
    mate_min: int = 0
    mate_max: int = TEMPLATE_LENGTH_THRESHOLD
    best0: int = 1   # FRp
    best1: int = 6   # RFm
    median: int = 0  # --mate-drift-range window center

    @staticmethod
    def from_stats(s: TemplateLengthStatistics) -> "TlsStatic":
        return TlsStatic(median=s.median,
                         min=s.min, max=s.max, mate_min=s.mate_min,
                         mate_max=s.mate_max,
                         best0=s.best_models[0], best1=s.best_models[1])

    def to_stats(self) -> TemplateLengthStatistics:
        s = TemplateLengthStatistics(min=self.min, max=self.max,
                                     best_models=(self.best0, self.best1))
        s.mate_min, s.mate_max = self.mate_min, self.mate_max
        return s


jax.tree_util.register_dataclass(
    TlsStatic,
    data_fields=["min", "max", "mate_min", "mate_max", "best0", "best1",
                 "median"],
    meta_fields=[])


def quantize_rescue_window(span: int, cap: int) -> int:
    """Round a TLS mate-window span up to a power-of-two bucket (>=256).

    The rescue window sets kernel SHAPES, so it must stay a static jit
    argument; quantizing it bounds the number of compiled executables to
    ~5 (256..4096) across all learned TLS models.  When the power of two
    overshoots `cap` but the span itself still fits, `cap` is used as the
    final bucket so the enable/disable decision matches the span, not the
    bucket."""
    win = 256
    while win < span:
        win *= 2
    if win > cap >= span:
        win = cap
    return win


def pair_model(pos1, rev1, pos2, rev2):
    """Alignment model id (TemplateLengthStatistics.hh:153-162)."""
    pos_mask = jnp.where(pos1 <= pos2, 0, 4)
    return pos_mask | (rev1.astype(jnp.int32) << 1) | rev2.astype(jnp.int32)


def pair_length(pos1, len1, pos2, len2):
    """Template length (TemplateLengthStatistics.hh:166-177)."""
    lo_first = pos1 < pos2
    span1 = pos2 + len2 - pos1
    span2 = pos1 + len1 - pos2
    return jnp.where(lo_first, jnp.maximum(span1, len1), jnp.maximum(span2, len2))


def resolve_pairs(cfg: AlignConfig, tls: TlsStatic, end1: dict, end2: dict,
                  log_rog_template: float):
    """Dense pair search over both candidate lists.

    Each end dict needs: start, orient, valid, cid, log_prob, sw_score,
    obs_len — all [B, C].  Returns a dict with best-pair indices, the
    template score, proper flag and probability sums, all [B]-shaped.
    Probability mass is computed on the exp(-m) scale (quality.py scaled
    helpers): raw f32 exponentials underflow for high-mismatch pairs and
    collapsed the template score to 0 where the reference's double math
    (TemplateBuilder.cpp:435-447) gives a real value.  `total_prob` in
    the result is SCALED; `log_scale` carries m for host f64 consumers.
    """
    p1 = end1["start"][:, :, None]
    p2 = end2["start"][:, None, :]
    r1 = end1["orient"][:, :, None]
    r2 = end2["orient"][:, None, :]
    l1 = end1["obs_len"][:, :, None]
    l2 = end2["obs_len"][:, None, :]

    same_contig = end1["cid"][:, :, None] == end2["cid"][:, None, :]
    both_valid = end1["valid"][:, :, None] & end2["valid"][:, None, :]
    model = pair_model(p1, r1, p2, r2)
    length = pair_length(p1, l1, p2, l2)
    in_models = (model == tls.best0) | (model == tls.best1)
    match = both_valid & same_contig & in_models & \
        (length <= tls.max + TEMPLATE_LENGTH_THRESHOLD)

    pair_lp = end1["log_prob"][:, :, None] + end2["log_prob"][:, None, :]
    pair_sw = end1["sw_score"][:, :, None] + end2["sw_score"][:, None, :]

    b, c1, c2 = match.shape
    # scaled pair mass: m = max matched pair lp per row
    m = jnp.max(jnp.where(match, pair_lp, -jnp.inf).reshape(b, -1), axis=1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    prob = jnp.where(match, jnp.exp(pair_lp - m_safe[:, None, None]), 0.0)
    total_prob = jnp.sum(prob, axis=(1, 2))
    key = jnp.where(match, pair_sw.astype(jnp.float32) * jnp.float32(1e5) - pair_lp,
                    jnp.float32(jnp.inf)).reshape(b, c1 * c2)
    if cfg.scatter_repeats:
        # --scatter-repeats (manual.md:503): exact-tie repeat pairs pick
        # by per-(read, start1, start2) hash instead of lowest position
        kmin = jnp.min(key, axis=1, keepdims=True)
        tie = jnp.isfinite(key) & (key <= kmin)
        row = jnp.arange(b, dtype=jnp.int32)[:, None, None]
        h = scatter_hash(jnp.broadcast_to(row, match.shape),
                         jnp.broadcast_to(p1, match.shape),
                         jnp.broadcast_to(p2, match.shape)).reshape(b, -1)
        best_flat = jnp.argmax(jnp.where(tie, h, -1), axis=1)
    else:
        best_flat = jnp.argmin(key, axis=1)
    i1 = best_flat // c2
    i2 = best_flat % c2
    resolved = jnp.any(match.reshape(b, -1), axis=1)

    take1 = lambda x: jnp.take_along_axis(x, i1[:, None], axis=1)[:, 0]
    take2 = lambda x: jnp.take_along_axis(x, i2[:, None], axis=1)[:, 0]
    best_lp = take1(end1["log_prob"]) + take2(end2["log_prob"])
    best_model = pair_model(take1(end1["start"]), take1(end1["orient"]),
                            take2(end2["start"]), take2(end2["orient"]))
    best_len = pair_length(take1(end1["start"]), take1(end1["obs_len"]),
                           take2(end2["start"]), take2(end2["obs_len"]))
    proper = resolved & ((best_model == tls.best0) | (best_model == tls.best1)) & \
        (best_len >= tls.min) & (best_len <= tls.max)

    # template alignment score (TemplateBuilder.cpp:435-447) on the
    # exp(-m) scale — the scale cancels in the ratio
    p_best = jnp.where(resolved, jnp.exp(best_lp - m_safe), 0.0)
    rog_s = quality.rog_scaled(log_rog_template, m_safe)
    others = jnp.maximum(total_prob - p_best, 0.0) + rog_s
    denom = total_prob + rog_s
    template_score = jnp.floor(-10.0 * jnp.log10(
        jnp.maximum(others / jnp.maximum(denom, 1e-38), 1e-38))
    ).astype(jnp.int32)
    template_score = jnp.where(resolved, template_score, -1)

    return {
        "resolved": resolved,
        "i1": i1,
        "i2": i2,
        "proper": proper,
        "template_length": jnp.where(resolved, best_len, 0),
        "template_score": template_score,
        "total_prob": total_prob,    # scaled by exp(-log_scale)
        "log_scale": m_safe,
        "best_lp": best_lp,
    }


def end_mapping_score(end: dict, best_index, log_rog_read: float):
    """alignmentScore of the chosen fragment vs its end's candidates,
    on the exp(-m) scale.  Returns (score, others_scaled, log_scale)."""
    best_lp = jnp.take_along_axis(end["log_prob"], best_index[:, None], axis=1)[:, 0]
    total_s, p_best_s, m_safe = quality.scaled_masses(
        end["log_prob"], end["valid"], best_lp)
    score = jnp.floor(quality.mapping_quality_scaled(
        total_s, p_best_s, quality.rog_scaled(log_rog_read, m_safe))
    ).astype(jnp.int32)
    return score, jnp.maximum(total_s - p_best_s, 0.0), m_safe


def align_paired_batch(arrays: IndexArrays, bases1, quals1, bases2, quals2,
                       cfg: AlignConfig, tls: TlsStatic,
                       tail_masked1=None, tail_masked2=None, find_fn=None,
                       score_fn=None, clip_fn=None):
    """Jittable paired-end alignment of one read-pair batch.

    Equivalent of TemplateBuilder::buildTemplate for the paired case
    (TemplateBuilder.cpp:90-140): resolve the best TLS-compatible pair;
    rows without one fall back to independent single-end picks
    (buildDisjoinedTemplate, :716) — orphan rows (one end candidate-less)
    are flagged for the host to route through rescue_shadows.

    Returns a dict with per-end arrays (suffix _1/_2) and pair arrays.
    """
    from .pipeline import (quality_trim_device, score_end,
                           semialigned_clip_device)

    b, l1 = bases1.shape
    _, l2 = bases2.shape
    from .pipeline import genome_len_of
    g = genome_len_of(arrays, cfg)
    tm1 = jnp.zeros(b, jnp.int32) if tail_masked1 is None else tail_masked1
    tm2 = jnp.zeros(b, jnp.int32) if tail_masked2 is None else tail_masked2
    qt1 = jnp.zeros(b, jnp.int32)
    qt2 = jnp.zeros(b, jnp.int32)
    if cfg.quality_trim_cutoff > 0:
        bases1, quals1, qt1 = quality_trim_device(
            bases1, quals1, cfg.quality_trim_cutoff, tm1)
        bases2, quals2, qt2 = quality_trim_device(
            bases2, quals2, cfg.quality_trim_cutoff, tm2)
    from .pipeline import find_seed_hits
    find_fn = find_fn or find_seed_hits
    end1 = score_end(arrays, cfg, bases1, quals1, find_fn, score_fn)
    end2 = score_end(arrays, cfg, bases2, quals2, find_fn, score_fn)
    out = paired_from_ends(g, l1, l2, cfg, tls, end1, end2)
    out["qtrim_1"] = qt1
    out["qtrim_2"] = qt2
    if cfg.semialigned_clip:
        for sfx, (bb, tm, qt) in (("_1", (bases1, tm1, qt1)),
                                  ("_2", (bases2, tm2, qt2))):
            sa = (clip_fn or semialigned_clip_device)(
                arrays, cfg, bb, out["start" + sfx], out["reverse" + sfx],
                out["aligned" + sfx], tm + qt)
            out.update({k + sfx: v for k, v in sa.items()})
    return out


def paired_from_ends(g: int, l1: int, l2: int, cfg: AlignConfig,
                     tls: TlsStatic, end1: dict, end2: dict):
    """Pair resolution + scoring from two scored end dicts (the tail of
    align_paired_batch; the SPMD path builds its ends from per-shard hit
    lists and reuses this verbatim)."""
    log_rog_t = quality.log_rest_of_genome_correction(g, l1 + l2)
    log_rog1 = quality.log_rest_of_genome_correction(g, l1)
    log_rog2 = quality.log_rest_of_genome_correction(g, l2)

    pairs = resolve_pairs(cfg, tls, end1, end2, log_rog_t)

    def se_best(end):
        key = jnp.where(end["valid"],
                        end["sw_score"].astype(jnp.float32) * jnp.float32(1e5)
                        - end["log_prob"], jnp.float32(jnp.inf))
        return jnp.argmin(key, axis=1)

    se1, se2 = se_best(end1), se_best(end2)
    idx1 = jnp.where(pairs["resolved"], pairs["i1"], se1)
    idx2 = jnp.where(pairs["resolved"], pairs["i2"], se2)

    def _gate(end, idx, score):
        wa = jnp.take_along_axis(end["well_anchored"].astype(jnp.int32),
                                 idx[:, None], axis=1)[:, 0]
        return jnp.where(wa == 1, score, 0)

    raw1, others1, scale1 = end_mapping_score(end1, idx1, log_rog1)
    raw2, others2, scale2 = end_mapping_score(end2, idx2, log_rog2)
    score1 = _gate(end1, idx1, raw1)
    score2 = _gate(end2, idx2, raw2)
    # dodgy repeats (scored-candidate overflow): forced score, optional
    # unaligned marking — reference --dodgy-alignment-score semantics
    score1 = jnp.where(end1["dodgy"], jnp.int32(cfg.dodgy_mapq), score1)
    score2 = jnp.where(end2["dodgy"], jnp.int32(cfg.dodgy_mapq), score2)

    def end_out(end, idx, frag_score, others, scale, suffix):
        take = lambda x: jnp.take_along_axis(x, idx[:, None], axis=1)[:, 0]
        aligned = jnp.any(end["valid"], axis=1)
        if cfg.dodgy_unaligned:
            aligned = aligned & ~end["dodgy"]
        return {
            # SCALED neighborhood mass + its log scale: host consumers
            # (gapped/indel polish, multi-index merge) recover the raw
            # f64 mass as others_sum * exp(log_scale)
            f"others_sum{suffix}": others,
            f"log_scale{suffix}": scale,
            f"cand_start{suffix}": end["start"],
            f"cand_orient{suffix}": end["orient"],
            f"cand_valid{suffix}": end["valid"],
            f"cand_mismatches{suffix}": end["mismatches"],
            f"aligned{suffix}": aligned,
            f"start{suffix}": jnp.where(aligned, take(end["start"]), -1),
            f"reverse{suffix}": take(end["orient"]) == 1,
            f"mismatches{suffix}": take(end["mismatches"]),
            f"edit_distance{suffix}": take(end["edit"]),
            f"log_prob{suffix}": take(end["log_prob"]),
            f"frag_score{suffix}": jnp.where(aligned, frag_score, 0),
            f"num_candidates{suffix}": end["num_candidates"],
        }

    out = {}
    out.update(end_out(end1, idx1, score1, others1, scale1, "_1"))
    out.update(end_out(end2, idx2, score2, others2, scale2, "_2"))
    for sfx, end in (("_1", end1), ("_2", end2)):
        for k, v in end.get("finder_stats", {}).items():
            out[f"{k}{sfx}"] = v
    out["pair_resolved"] = pairs["resolved"]
    # probability-mass components for host-side cross-group merging
    # (parallel/multi_index.py): template score re-derives from these;
    # pair_total_prob is exp(-pair_log_scale)-scaled
    out["pair_total_prob"] = pairs["total_prob"]
    out["pair_log_scale"] = pairs["log_scale"]
    out["pair_best_lp"] = pairs["best_lp"]
    out["proper_pair"] = pairs["proper"]
    out["template_length"] = pairs["template_length"]
    out["template_score"] = jnp.where(
        end1["dodgy"] | end2["dodgy"], jnp.int32(-1),
        jnp.clip(pairs["template_score"], -1, cfg.mapq_cap))
    # shadow rows: exactly one end aligned — host routes these through
    # rescue (iSAAC terms: the aligned end is the "orphan", the unaligned
    # mate the "shadow"; shadow_1 == end 1 is the shadow)
    out["shadow_1"] = out["aligned_2"] & ~out["aligned_1"]
    out["shadow_2"] = out["aligned_1"] & ~out["aligned_2"]
    # disjoined rows: both ends aligned but no TLS-compatible pair — the
    # reference re-anchors a rescue at EACH end and adopts the best
    # rescued template (TemplateBuilder::buildDisjoinedTemplate,
    # TemplateBuilder.cpp:716-866); the driver routes these through the
    # same rescue kernel, once per anchoring direction
    out["disjoined"] = out["aligned_1"] & out["aligned_2"] \
        & ~out["pair_resolved"]
    return out


# ---------------------------------------------------------------------------
# Shadow rescue
# ---------------------------------------------------------------------------

def mate_window_dynamic(tls, read_index: int, read_lengths, reverse):
    """Per-row mate-window offsets + shadow orientation, computed with
    jnp bit-logic from (possibly traced) TLS fields
    (TemplateLengthStatistics.cpp:186-240 — mateMin/MaxPosition,
    mateOrientation, with the reference's first-matching-best-model-wins
    fallback semantics).

    `read_index`/`read_lengths` are static; `reverse` is a [Rb] bool
    array.  Returns (min_off, max_off, shadow_rev) where the offsets are
    relative to the orphan position."""
    rev = jnp.asarray(reverse).astype(jnp.int32)
    shift = 1 - read_index
    b0 = jnp.asarray(tls.best0, jnp.int32)
    b1 = jnp.asarray(tls.best1, jnp.int32)
    m0 = ((b0 >> shift) & 1) == rev
    m1 = ((b1 >> shift) & 1) == rev
    valid = m0 | m1
    chosen = jnp.where(m0, b0, jnp.where(m1, b1, b0))
    # firstFragment: model<4 means read 0 leftmost (ReferencePosition bit)
    first = (chosen < 4) == (read_index == 0)
    shadow_rev = ((chosen >> read_index) & 1) != 0
    own_len = read_lengths[read_index]
    mate_len = read_lengths[1 - read_index]
    mm = jnp.asarray(tls.mate_min, jnp.int32)
    mx = jnp.asarray(tls.mate_max, jnp.int32)
    mn_off = jnp.where(first, mm - mate_len, -mx + own_len)
    mx_off = jnp.where(first, mx - mate_len, -mm + own_len)
    zero = jnp.int32(0)
    return (jnp.where(valid, mn_off, zero), jnp.where(valid, mx_off, zero),
            shadow_rev)


def rescue_shadows(arrays: IndexArrays, cfg: AlignConfig, tls: TlsStatic,
                   orphan_read_index: int, read_lengths: tuple[int, int],
                   orphan_start, orphan_rev,
                   shadow_bases, shadow_quals, window: int):
    """Score the shadow read at every offset of the TLS mate window.

    Args are [Rb]-batched (host-compacted orphan rows, padded):
      orphan_start/rev: best orphan candidate; shadow_bases/quals [Rb, L2];
      read_lengths: static (read-0 length, read-1 length) of the pair
      geometry; window: static number of offsets scanned
      (>= mate_max - mate_min + 1).

    Returns dict: found, start, reverse, mismatches, edit, log_prob,
    total_prob (for rescued-pair scoring) — all [Rb].
    """
    rb, l2 = shadow_bases.shape

    # per-row window start + shadow orientation from the (dynamic) TLS
    # model — no recompile when the learned model changes
    mn_off, mx_off, shadow_rev = mate_window_dynamic(
        tls, orphan_read_index, read_lengths, orphan_rev)
    win_start = orphan_start + mn_off
    win_end = orphan_start + mx_off

    rc_bases = bitops.revcomp_reads(shadow_bases)
    r_quals = bitops.reverse_quals(shadow_quals)
    seq = jnp.where(shadow_rev[:, None], rc_bases, shadow_bases)
    q = jnp.where(shadow_rev[:, None], r_quals, shadow_quals).astype(jnp.int32)

    from .pipeline import (GENOME_PAD, GN_PAD_WORDS, GP_PAD_WORDS,
                           genome_len_of)
    g = genome_len_of(arrays, cfg)
    offs = jnp.arange(window, dtype=jnp.int32)
    starts = win_start[:, None] + offs[None, :]                   # [Rb, W]
    pos_ok = (starts >= 0) & (starts + l2 <= g) & (starts <= win_end[:, None])

    # reference span from the PACKED planes (not the raw codes plane):
    # one contiguous word gather covering [win_start, win_start+W+L2),
    # funnel-shifted into phase and lane-expanded — 16x less HBM read
    # than the old per-(offset, base) byte gather, and the only genome
    # access in the whole rescue (enables dropping the codes plane from
    # HBM and position-sharding the genome)
    span_len = window + l2
    w_span = -(-span_len // 16) + 1
    # gather origin: clamp to the plane's first representable position
    # (plane_base - GENOME_PAD) so a window hanging far off the genome
    # start cannot wrap the word index; the sub-origin offsets are
    # position-masked (pos_ok) anyway, and a per-row re-phase below puts
    # the span back into win_start alignment
    origin = jnp.maximum(win_start,
                         jnp.int32(arrays.plane_base) - GENOME_PAD)
    gp = arrays.genome_packed
    gw = gp.shape[0]
    word0 = ((origin - arrays.plane_base) >> 4) + GP_PAD_WORDS    # [Rb]
    widx = jnp.clip(word0[:, None]
                    + jnp.arange(w_span, dtype=jnp.int32)[None, :], 0, gw - 1)
    words = gp[widx]                                              # [Rb, Ws]
    o2 = ((origin & 15) << 1).astype(jnp.uint32)[:, None]
    safe = jnp.where(o2 == 0, jnp.uint32(1), jnp.uint32(32) - o2)
    al_w = jnp.where(o2 == 0, words[:, :-1],
                     (words[:, :-1] << o2) | (words[:, 1:] >> safe))
    lane_shifts = jnp.asarray((2 * (15 - np.arange(16))).astype(np.uint32))
    span = ((al_w[:, :, None] >> lane_shifts[None, None, :]) & jnp.uint32(3)
            ).reshape(rb, (w_span - 1) * 16)[:, :span_len].astype(jnp.uint8)
    if cfg.genome_has_n:
        gn = arrays.genome_nbits
        gnw = gn.shape[0]
        w_n = -(-span_len // 32) + 1
        nword0 = ((origin - arrays.plane_base) >> 5) + GN_PAD_WORDS
        nwidx = jnp.clip(nword0[:, None]
                         + jnp.arange(w_n, dtype=jnp.int32)[None, :],
                         0, gnw - 1)
        nwords = gn[nwidx]
        no = (origin & 31).astype(jnp.uint32)[:, None]
        nsafe = jnp.where(no == 0, jnp.uint32(1), jnp.uint32(32) - no)
        nal = jnp.where(no == 0, nwords[:, :-1],
                        (nwords[:, :-1] << no) | (nwords[:, 1:] >> nsafe))
        nlane = jnp.asarray((31 - np.arange(32)).astype(np.uint32))
        span_n = (((nal[:, :, None] >> nlane[None, None, :]) & jnp.uint32(1))
                  != 0).reshape(rb, (w_n - 1) * 32)[:, :span_len]
    else:
        span_n = jnp.zeros((rb, span_len), bool)

    # re-phase the span from `origin` back to win_start alignment
    # (d > 0 only for clamped rows; shifted-in elements cover positions
    # below the genome start, which pos_ok masks)
    d = (win_start - origin)[:, None]                             # <= 0
    k = jnp.arange(span_len, dtype=jnp.int32)[None, :]
    rp = jnp.clip(k + d, 0, span_len - 1)
    span = jnp.take_along_axis(span, rp, axis=1)
    span_n = jnp.take_along_axis(span_n, rp, axis=1) | (k + d < 0)

    sl_idx = offs[:, None] + jnp.arange(l2, dtype=jnp.int32)[None, :]  # [W, L2]
    ref = span[:, sl_idx]                                         # [Rb, W, L2]
    ref_n = span_n[:, sl_idx]
    s3 = seq[:, None, :]
    is_match = (s3 == dna.N) | ((s3 == ref) & ~ref_n)
    t_match, t_mismatch = quality.log_tables()
    lp = jnp.sum(jnp.where(is_match, t_match[q][:, None, :],
                           t_mismatch[q][:, None, :]), axis=-1)
    nmm = jnp.sum(~is_match, axis=-1).astype(jnp.int32)
    edit = jnp.sum((s3 != ref) | (s3 == dna.N) | ref_n,
                   axis=-1).astype(jnp.int32)

    lp = jnp.where(pos_ok, lp, -jnp.inf)
    key = jnp.where(pos_ok, nmm.astype(jnp.float32) * jnp.float32(1e5) - lp,
                    jnp.float32(jnp.inf))
    best = jnp.argmin(key, axis=1)
    take = lambda x: jnp.take_along_axis(x, best[:, None], axis=1)[:, 0]

    max_mm = jnp.int32(int(l2 * cfg.rescue_max_mismatch_frac))
    found = jnp.any(pos_ok, axis=1) & (take(nmm) <= max_mm)
    total_prob = jnp.sum(jnp.where(pos_ok, jnp.exp(lp), 0.0), axis=1)

    # rescued-pair score, in kernel and in LOG SPACE (the reference's
    # rescued-template scoring, TemplateBuilder rescued path): a
    # high-mismatch rescue's exp(lp) underflows f32, so the neighborhood
    # ratio r = others/p_best is assembled from scaled exponentials:
    #   r = (sum_w exp(lp_w - m) - exp(lp_best - m)) / exp(lp_best - m)
    #       + exp(log_rog - lp_best)
    #   score = -10*log10(r / (r + 1))
    # One implementation serves the host rescue pass and the in-program
    # SPMD rescue, keeping their outputs bit-identical.
    lp_best = take(lp)
    m = jnp.max(jnp.where(pos_ok, lp, -jnp.inf), axis=1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    sum_r = jnp.sum(jnp.where(pos_ok, jnp.exp(lp - m_safe[:, None]), 0.0),
                    axis=1)
    e_best = jnp.exp(lp_best - m_safe)
    log_rog = quality.log_rest_of_genome_correction(
        int(g), read_lengths[0] + read_lengths[1])
    rog_term = jnp.exp(jnp.clip(jnp.float32(log_rog) - lp_best, -80.0, 80.0))
    r = jnp.maximum(sum_r - e_best, 0.0) / jnp.maximum(e_best, 1e-30) \
        + rog_term
    score_f = -10.0 * jnp.log10(r / (r + 1.0))
    score_f = jnp.where(jnp.isfinite(score_f), score_f,
                        jnp.float32(cfg.mapq_cap))
    score = jnp.clip(jnp.floor(score_f), 0, cfg.mapq_cap).astype(jnp.int32)

    return {
        "found": found,
        "start": take(starts),
        "reverse": shadow_rev,
        "mismatches": take(nmm),
        "edit_distance": take(edit),
        "log_prob": take(lp),
        "total_prob": total_prob,
        "score": score,
    }
