"""The fused on-device alignment pipeline (single-end slice).

This is the device recomposition of the reference's MatchFinder +
MatchSelector phases (SURVEY.md §3.2/§3.3).  Where the reference streams
seeds/matches through temp files and per-cluster scalar loops, here one
jitted program takes a fixed-shape read batch and the device-resident index
through:

    seed packing -> binary-search match -> candidate projection/dedup ->
    window gather -> ungapped scoring -> best pick -> MAPQ

Everything is fixed shape: matches per seed are capacity-bounded gathers
(reference repeatThreshold semantics, ExactMaskMatcher.cpp:83-210),
candidates per read are capacity-bounded after dedup (reference
FragmentBuilder consolidateDuplicateFragments, FragmentBuilder.cpp:82-346),
and overflow is carried as explicit flags — the tensorized version of the
reference's NoMatch/TooManyMatch sentinels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna
from ..index.build import SeedIndex, TOO_MANY_POS
from ..ops import bitops, search
from . import quality


BUCKET_WIDTH = 16

# head/tail padding of the packed genome planes, in WORDS: 256 bases of
# out-of-genome sentinel each side so candidates overhanging a contig (or
# the genome) edge can still gather aligned windows; overhanging lanes are
# masked out of scoring by the per-position in-contig mask
GP_PAD_WORDS = 16     # 2-bit plane: 16 bases/word -> 256 bases
GN_PAD_WORDS = 8      # N-bit plane: 32 bases/word -> 256 bases
GENOME_PAD = GP_PAD_WORDS * 16


class IndexArrays(NamedTuple):
    """Device-resident index planes (a pytree — jit-traceable)."""

    key_hi: jax.Array       # int32 [Npad] sorted, biased; padded with I32_MAX
    key_lo: jax.Array       # int32 [Npad]
    pos: jax.Array          # int32 [Npad] global positions / TOO_MANY_POS
    n_real: jax.Array       # int32 [] number of real records
    genome: jax.Array       # uint8 [G] base codes 0..4
    contig_starts: jax.Array  # int32 [n_contigs] sorted
    contig_ends: jax.Array    # int32 [n_contigs]
    has_neighbors: jax.Array  # uint8 [Npad] "k-mer has <=4mm neighbors" bits
    # packed genome planes for the gather-light scorer: 16 bases per uint32
    # word (big-endian lanes) + 32 N-bits per word; one word of tail padding
    genome_packed: jax.Array   # uint32 [ceil(G/16) + 1]
    genome_nbits: jax.Array    # uint32 [ceil(G/32) + 1]
    # first-level prefix-bucket table (reference maskWidth sharding as an
    # O(1) lookup): record range per top-BUCKET_WIDTH-bits prefix
    bucket_starts: jax.Array   # int32 [2^BUCKET_WIDTH + 1]
    # genome-position offset of the packed planes: plane word 0 covers
    # global base `plane_base` (minus the sentinel padding).  0 for the
    # whole-genome planes; the genome-sharded SPMD mode
    # (parallel/sharded.py shard_genome_planes) sets each device's slice
    # origin so every packed-plane gather indexes locally.
    plane_base: "jax.Array | int" = 0
    # 64-mer LongKmerType middle key planes (bases 16..32, 32..48):
    # empty tuple for 16/32-mer indexes (reference include/oligo/Kmer.hh
    # :32-38 — __uint128 keys become four int32 words here)
    key_mids: tuple = ()


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Static alignment parameters (hashable: used as a jit static arg).

    Defaults mirror the reference align-time settings: seed length 32
    with seeds tiled across the read (SeedMetadata auto generation),
    repeat threshold 10 (reference --repeat-threshold default,
    src/markdown/manual.md), MAPQ cap 60 (FragmentAccessorBamAdapter.hh:250).
    """

    seed_len: int = 32
    seed_offsets: tuple[int, ...] = (0, 32)
    # seed length of the INDEX records (set by Aligner.create from the
    # index).  None = min(seed_len, 32): the compatibility default for
    # directly-built configs.  seed_len=64 over a 32-mer index runs
    # 32-mer search + extension verify; over a TRUE 64-mer index
    # (index_seed_len=64) the search compares all four key words, so
    # repeat suppression happens at 64-mer granularity.
    index_seed_len: int | None = None
    max_hits_per_seed: int = 10      # gather capacity == align repeat threshold
    repeat_threshold: int = 10
    max_candidates: int = 32
    # candidates actually scored (leading dedup slots).  Reads with more
    # distinct candidates than this are repeat placements whose probability
    # mass can't be fully tracked -> forced MAPQ 0, the reference's dodgy
    # template handling (forcedDodgyAlignmentScore,
    # FragmentAccessorBamAdapter.hh).  Scoring cost scales linearly with
    # this cap; 16 covers everything a 10-per-seed repeat threshold can
    # produce outside pathological repeats.
    max_scored_candidates: int = 16
    # compacted scoring: valid (read, candidate) pairs across the batch
    # are gathered into a dense [B * scored_pairs_per_read] work queue
    # before the window-gather scorer runs (typical batches carry ~1-2
    # candidates per read, so scoring the full [B, C] grid wastes >85%
    # of the gathers and VPU work).  Reads whose pairs overflow the
    # queue keep their best scored placement but are forced MAPQ 0.
    scored_pairs_per_read: int = 3
    # two-pass seed escalation (reference --first-pass-seeds=1 + completion
    # masking, FindMatchesTransition.cpp:90-109,410-425): pass 1 searches
    # only the first `first_pass_seeds` seed offsets (fwd+rc); reads with
    # a clean (neighbor-free) exact hit whose valid hits all agree on one
    # placement are COMPLETE and skip pass 2.  Incomplete reads compact
    # into a batch*second_pass_fraction sub-batch searched with ALL seeds
    # (disagreeing anchors stay incomplete so long-indel detection keeps
    # both anchors).  0 disables the escalation.
    first_pass_seeds: int = 1
    second_pass_fraction: float = 0.25
    mapq_cap: int = 60
    # shadow rescue acceptance: max mismatch fraction of the rescued mate
    # (the reference gates rescue via hash-hit heuristics + later quality
    # filters, ShadowAligner.cpp; a fraction cap is the tensorized stand-in)
    rescue_max_mismatch_frac: float = 0.25
    # neighbor second-chance matching (reference NeighborMaskMatcher,
    # --neighborhood-size-threshold, default 0 = disabled as in
    # AlignOptions.cpp:96): seeds with no exact hit scan their 16-base
    # prefix block for suffix-Hamming<=1 reference k-mers, provided the
    # block holds <= threshold records.  Blocks larger than the static
    # scan cap are skipped (fixed-shape honesty).
    neighborhood_size_threshold: int = 0
    neighbor_scan_cap: int = 32
    # bucketed seed search: when set, binary search runs inside the
    # prefix bucket (2^bucket_log2 max records) instead of the full index
    # — log2 of the LARGEST bucket, host-computed by build_bucket_table.
    # None = plain full-range search (always correct, slower).
    bucket_log2: int | None = None
    bucket_width: int = BUCKET_WIDTH   # must match the prepared table
    # reference --dodgy-alignment-score (manual.md:367-370): MAPQ assigned
    # when the score is impossible to track (repeat overflow); dodgy
    # reads can also be marked unaligned entirely ("Unaligned")
    dodgy_mapq: int = 0
    dodgy_unaligned: bool = False
    # reference --ignore-neighbors (manual.md:403): when set, hits from
    # neighbor-annotated k-mers count as clean anchors anyway (the
    # default treats them as unanchoring, FragmentMetadata::isWellAnchored)
    ignore_neighbors: bool = False
    # reference --ignore-repeats (manual.md:405): when set, seeds whose
    # exact k-mer is a suppressed repeat still enter the inexact
    # (neighbor Hamming<=1) matching pass instead of being blocked
    ignore_repeats: bool = False
    # reference --scatter-repeats (manual.md:503): when set, exact
    # score ties between repeat placements break on a per-(read, start)
    # hash instead of always taking the lowest genome position, so
    # repeat piles spread across the copies (deterministic per batch)
    scatter_repeats: bool = False
    # on-device 3' quality trimming (reference trimLowQualityEnds,
    # Quality.cpp:72-120): 0 disables.  When set, the device program masks
    # low-quality tails itself (identical math to the host
    # clippers.quality_trim_batch walk) and reports per-read trim counts
    # as `qtrim` — the host [B, L] numpy walk was a top e2e cost
    quality_trim_cutoff: int = 0
    # on-device semialigned-end clipping (reference SemialignedEndsClipper,
    # 5-consecutive-match rule): emits sa_do/sa_lead/sa_tail/sa_removed/
    # sa_pos for the best ungapped placement; the host rewrites CIGARs for
    # flagged rows only (clippers.apply_semialigned_device)
    semialigned_clip: bool = False
    # static "genome contains N bases" flag (set from the index by
    # Aligner.create): N-free genomes skip the N-bit-plane gathers in the
    # scorer and the 64-mer extension check (~30% of scoring gathers)
    genome_has_n: bool = True
    # static genome length (set from the index by Aligner.create).  When
    # set, the device programs derive G from here instead of the raw
    # codes plane's shape — which lets production paths skip uploading
    # the uint8 codes plane entirely (the scorer/clipper/rescue all read
    # the PACKED planes; ~G bytes of HBM saved) and lets the
    # genome-sharded SPMD mode hold only a genome slice per device.
    genome_len: int = 0


def genome_len_of(arrays: IndexArrays, cfg: AlignConfig) -> int:
    """Static genome length: cfg.genome_len when set, else the raw codes
    plane's shape (the compatibility path for directly-built configs)."""
    return cfg.genome_len or int(arrays.genome.shape[0])


def pack_genome(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack base codes into 2-bit words + an N-bit plane (host, numpy).

    Word w holds bases [16w, 16w+16) big-endian (base 16w in the top two
    bits) so lexicographic base order matches word order; N packs as code
    0 with its bit set in the 1-bit-per-base plane (32 bases per word,
    base 32w in bit 31).  GENOME_PAD bases of out-of-genome sentinel
    (N-bit set) pad BOTH ends: consumers add GP_PAD_WORDS/GN_PAD_WORDS to
    their word indexes, and candidates overhanging contig/genome edges
    gather correctly (the per-position in-contig mask excludes the
    overhang from scoring — reference AlignerBase contig-end clipping).
    """
    g = codes.shape[0]
    n16 = -(-g // 16)
    padded = np.zeros(n16 * 16, np.uint32)
    clean = np.where(codes < 4, codes, 0).astype(np.uint32)
    padded[:g] = clean
    lanes = padded.reshape(n16, 16)
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    packed = (lanes << shifts[None, :]).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    zpad = np.zeros(GP_PAD_WORDS, np.uint32)
    packed = np.concatenate([zpad, packed, zpad])

    n32 = -(-g // 32)
    nb = np.zeros(n32 * 32, np.uint32)
    nb[:g] = (codes >= 4).astype(np.uint32)
    # genome tail inside the last real word is out-of-genome: N
    nb[g:] = 1
    nlanes = nb.reshape(n32, 32)
    nshifts = (31 - np.arange(32)).astype(np.uint32)
    nbits = (nlanes << nshifts[None, :]).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    npad = np.full(GN_PAD_WORDS, 0xFFFFFFFF, np.uint32)
    nbits = np.concatenate([npad, nbits, npad])
    return packed, nbits


def pack_reads(bases: jax.Array) -> jax.Array:
    """Pack [B, L] read codes into [B, ceil(L/16)] big-endian uint32 words
    (N and tail padding pack as 0; callers mask them separately)."""
    b, l = bases.shape
    w = -(-l // 16)
    pad = w * 16 - l
    x = bases.astype(jnp.uint32)
    x = jnp.where(x < 4, x, 0)
    if pad:
        x = jnp.concatenate([x, jnp.zeros((b, pad), jnp.uint32)], axis=1)
    lanes = x.reshape(b, w, 16)
    shifts = jnp.asarray((2 * (15 - np.arange(16))).astype(np.uint32))
    return jnp.sum(lanes << shifts[None, None, :], axis=2, dtype=jnp.uint32)


def choose_bucket_width(n_records: int) -> int:
    """Bucket-table width scaling with index size (~64 records/bucket
    expected): wider tables keep the per-query step count flat as the
    genome grows — chr21-scale indexes get 2^20 buckets, bacterial ones
    2^16."""
    import math
    if n_records <= 1:
        return BUCKET_WIDTH
    return min(20, max(BUCKET_WIDTH, int(math.log2(n_records / 64))))


def build_bucket_table(key_hi_i32: np.ndarray,
                       width: int = BUCKET_WIDTH) -> tuple[np.ndarray, int]:
    """Host-side first-level lookup table over the sorted key_hi plane.

    Returns (bucket_starts int32 [2^width + 1], bucket_log2) where
    bucket_starts[m] is the first record whose top `width` key bits are
    >= m, and 2^bucket_log2 bounds the largest bucket (the static step
    budget for sorted_range_bucketed).
    """
    from ..index.build import unbias_i32_to_u32
    qu = unbias_i32_to_u32(np.asarray(key_hi_i32, np.int32))
    n = len(qu)
    thresholds = (np.arange(1, 1 << width, dtype=np.uint64)
                  << (32 - width)).astype(np.uint32)
    edges = np.searchsorted(qu, thresholds, side="left")
    starts = np.concatenate([[0], edges, [n]]).astype(np.int32)
    max_bucket = int(np.diff(starts).max()) if n else 1
    log2 = 0
    while (1 << log2) < max(max_bucket, 1):
        log2 += 1
    return starts, max(log2, 1)


def _cached_bucket_table(index: SeedIndex) -> tuple[np.ndarray, int, int]:
    """(starts, width, log2) for the index, memoized on the instance —
    prepare_index and bucket_params_for share one computation."""
    width = choose_bucket_width(index.num_records)
    cached = getattr(index, "_bucket_table", None)
    if cached is None or cached[1] != width:
        starts, log2 = build_bucket_table(index.key_hi, width)
        cached = (starts, width, log2)
        index._bucket_table = cached
    return cached


def bucket_params_for(index: SeedIndex) -> tuple[int, int]:
    """(bucket_width, bucket_log2) matching prepare_index's table."""
    _starts, width, log2 = _cached_bucket_table(index)
    return width, log2


def genome_has_n_for(index: SeedIndex) -> bool:
    """Whether the genome contains any ambiguous base (cached)."""
    cached = getattr(index, "_has_n", None)
    if cached is None:
        cached = bool((index.genome.codes >= 4).any())
        index._has_n = cached
    return cached


def prepare_index(index: SeedIndex, upload_codes: bool = True) -> IndexArrays:
    """Upload a host SeedIndex into padded device planes.

    upload_codes=False skips the raw uint8 codes plane (~G bytes of HBM):
    every device consumer reads the PACKED planes; the raw plane only
    serves as a genome-length carrier for configs without
    cfg.genome_len (Aligner.create sets it and passes False)."""
    n = index.num_records
    n_pad = search.pad_pow2(max(n, 1))
    pad = n_pad - n
    i32max = np.int32(2**31 - 1)
    key_hi = np.concatenate([index.key_hi, np.full(pad, i32max, np.int32)])
    key_lo = np.concatenate([index.key_lo, np.full(pad, i32max, np.int32)])
    key_mids = tuple(
        jnp.asarray(np.concatenate([m, np.full(pad, i32max, np.int32)]))
        for m in index.key_mids)
    pos = np.concatenate([index.pos, np.full(pad, TOO_MANY_POS, np.int32)])
    nb = (index.has_neighbors if index.has_neighbors is not None
          else np.zeros(n, np.uint8))
    nb = np.concatenate([nb.astype(np.uint8), np.zeros(pad, np.uint8)])
    contigs = index.genome.contigs
    cached_planes = getattr(index, "_packed_planes", None)
    if cached_planes is not None:
        packed, nbits = cached_planes   # mmapped, saved by SeedIndex.save
    else:
        packed, nbits = pack_genome(index.genome.codes)
    bucket_starts, _width, _log2 = _cached_bucket_table(index)
    return IndexArrays(
        bucket_starts=jnp.asarray(bucket_starts),
        has_neighbors=jnp.asarray(nb),
        genome_packed=jnp.asarray(packed),
        genome_nbits=jnp.asarray(nbits),
        key_hi=jnp.asarray(key_hi),
        key_lo=jnp.asarray(key_lo),
        key_mids=key_mids,
        pos=jnp.asarray(pos),
        n_real=jnp.int32(n),
        genome=(jnp.asarray(index.genome.codes) if upload_codes
                else jnp.zeros(0, jnp.uint8)),
        contig_starts=jnp.asarray(np.array([c.offset for c in contigs], np.int32)),
        contig_ends=jnp.asarray(np.array([c.end for c in contigs], np.int32)),
    )


def default_seed_offsets(read_len: int, seed_len: int) -> tuple[int, ...]:
    """Seeds tiling the read plus one flush with the read end (reference:
    auto seed descriptor, lib/options/alignOptions/SeedDescriptorOption.cpp).
    The end-flush seed anchors read tails across long indels — without it
    a single indel wider than the SW band leaves the tail anchorless."""
    n = max(1, read_len // seed_len)
    offsets = [i * seed_len for i in range(n)]
    tail = read_len - seed_len
    if tail > offsets[-1]:
        offsets.append(tail)
    return tuple(offsets)


def seed_table(read_len: int, cfg: AlignConfig) -> list[tuple[int, int]]:
    """Static (orient, query-offset) seed list; orient-1 seeds live at the
    mirrored offset in the reverse-complemented read so both cover the
    same read window (reference: SeedLoader builds fwd+rc per seed)."""
    k = cfg.seed_len
    seed_list: list[tuple[int, int]] = []
    for off in cfg.seed_offsets:
        if off + k > read_len:
            continue
        seed_list.append((0, off))
        seed_list.append((1, read_len - off - k))
    if not seed_list:
        raise ValueError(f"no seed fits read_len={read_len} seed_len={k}")
    return seed_list


def scatter_hash(row, pos, extra=None):
    """Deterministic per-(read, placement) uint32 mix for
    --scatter-repeats tie-breaking (manual.md:503).  int32 inputs;
    splitmix-style multiply/xor-shift finisher so adjacent repeat copies
    get uncorrelated ranks.  Returns int32 >= 0 (top bit cleared) so the
    argmax sentinel -1 never collides."""
    h = row.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    h = h ^ (pos.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
    if extra is not None:
        h = h ^ (extra.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35))
    h = h ^ (h >> jnp.uint32(15))
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> jnp.uint32(12))
    return (h & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)


def _finder_stats_from_diag(diag: dict) -> dict:
    """MatchFinderStats analog (lib/statistics): per-batch seed outcome
    tallies — exact-miss / repeat-suppressed counts + pass-2 volumes."""
    finder = {}
    if "seed_match_counts" in diag:
        finder["seeds_no_match"] = jnp.sum(
            (diag["seed_match_counts"] == 0).astype(jnp.int32))
        finder["seeds_too_many"] = jnp.sum(
            diag["seed_too_many"].astype(jnp.int32))
    for key in ("pass2_reads", "pass2_dropped"):
        if key in diag:
            finder[key] = diag[key]
    return finder


def find_seed_hits(arrays: IndexArrays, cfg: AlignConfig, bases):
    """Stage A: seeds -> per-hit (start, orient, valid), flat [B, S*R].

    This is the per-index-shard stage: with the index sharded over a mesh
    axis, every device runs it against its local shard and the hit lists
    are concatenated (parallel/sharded.py) before dedup.
    """
    b, read_len = bases.shape
    k = cfg.seed_len
    idx_k = cfg.index_seed_len or min(k, 32)
    # seeds longer than the INDEX k are searched on their idx_k-mer
    # prefix, then each hit verifies the remaining ext bases against the
    # packed genome — the fallback 64-mer mode over a 32-mer index.  With
    # a true 64-mer LongKmerType index (idx_k == 64, four key planes) the
    # search compares the full key, so 32-mer repeats over the threshold
    # never suppress a 64-mer-unique seed
    # (reference include/oligo/Kmer.hh:32-38, ReferenceSorter.cpp:104-176).
    k_search = min(k, idx_k)
    k_ext = k - k_search
    n_words = max(k_search // 16, 2)    # 16/32 -> (hi, lo); 64 -> 4 words
    rc_bases = bitops.revcomp_reads(bases)
    seed_list = seed_table(read_len, cfg)

    wordps: list[list] = [[] for _ in range(n_words)]
    nmask, extws = [], []
    w_ext = -(-k_ext // 16)
    for orient, qoff in seed_list:
        q = bases if orient == 0 else rc_bases
        if k_search <= 32:
            hi, lo, has_n = bitops.pack_seed(q, qoff, k_search)
            ws = [hi, lo]
        else:
            hi, m1, n1 = bitops.pack_seed(q, qoff, 32)
            m2, lo, n2 = bitops.pack_seed(q, qoff + 32, 32)
            has_n = n1 | n2
            ws = [hi, m1, m2, lo]
        if k_ext:
            ext = q[:, qoff + k_search : qoff + k]
            has_n = has_n | jnp.any(ext >= dna.NUM_BASES, axis=1)
            extws.append(pack_reads(ext))           # [B, We] zero-padded
        for i, w in enumerate(ws):
            wordps[i].append(w)
        nmask.append(has_n)
    q_words = [jnp.stack(wp, axis=1) for wp in wordps]    # each [B, S]
    q_hi, q_lo = q_words[0], q_words[-1]
    q_mids = tuple(q_words[1:-1])
    seed_has_n = jnp.stack(nmask, axis=1)
    q_ext = jnp.stack(extws, axis=1) if k_ext else None   # [B, S, We]
    qoff_arr = jnp.asarray(np.array([s[1] for s in seed_list], np.int32))
    orient_arr = jnp.asarray(np.array([s[0] for s in seed_list], np.int32))

    if cfg.bucket_log2 is not None:
        # count only needs resolving up to "more than repeat_threshold"
        need = max(cfg.repeat_threshold, cfg.max_hits_per_seed) + 1
        cap_log2 = 0
        while (1 << cap_log2) < need:
            cap_log2 += 1
        begin, count = search.sorted_range_bucketed(
            arrays.key_hi, arrays.key_lo, q_hi, q_lo, arrays.n_real,
            arrays.bucket_starts, cfg.bucket_width, cfg.bucket_log2,
            count_cap_log2=cap_log2,
            key_mids=arrays.key_mids, q_mids=q_mids)
    else:
        begin, count = search.sorted_range(arrays.key_hi, arrays.key_lo,
                                           q_hi, q_lo, arrays.n_real,
                                           key_mids=arrays.key_mids,
                                           q_mids=q_mids)
    count = jnp.where(seed_has_n, 0, count)

    first_pos = arrays.pos[jnp.minimum(begin, arrays.key_hi.shape[0] - 1)]
    too_many = (count > cfg.repeat_threshold) | ((count > 0) & (first_pos == TOO_MANY_POS))
    eff = jnp.where(too_many, 0, jnp.minimum(count, cfg.max_hits_per_seed))

    r = jnp.arange(cfg.max_hits_per_seed, dtype=jnp.int32)
    hit_idx = begin[:, :, None] + r[None, None, :]          # [B, S, R]
    hit_valid = r[None, None, :] < eff[:, :, None]
    hit_pos = arrays.pos[jnp.minimum(hit_idx, arrays.key_hi.shape[0] - 1)]

    start = hit_pos - qoff_arr[None, :, None]
    orient = jnp.broadcast_to(orient_arr[None, :, None], start.shape)
    # anchoring confidence: a hit from a k-mer WITHOUT genomic neighbors
    # is a clean anchor (reference FragmentMetadata::isWellAnchored)
    hit_nb = arrays.has_neighbors[jnp.minimum(hit_idx, arrays.key_hi.shape[0] - 1)]
    clean = hit_valid if cfg.ignore_neighbors else hit_valid & (hit_nb == 0)

    # candidates may overhang a contig edge by up to max_over bases; the
    # scorer masks out-of-contig positions and the host soft-clips them
    # (reference AlignerBase.cpp:121-231 contig-end clipping).  At least
    # read_len//2 + 1 bases must stay inside so the middle base locates
    # the owning contig unambiguously.
    min_inside = read_len // 2 + 1
    max_over = min(read_len - min_inside, GENOME_PAD - 1)

    def contig_bounded(start_arr):
        mid = start_arr + read_len // 2
        cid = jnp.searchsorted(arrays.contig_starts, mid, side="right") - 1
        cid = jnp.clip(cid, 0, arrays.contig_starts.shape[0] - 1)
        cs = arrays.contig_starts[cid]
        ce = arrays.contig_ends[cid]
        return (mid >= cs) & (mid < ce) & \
               (start_arr >= cs - max_over) & \
               (start_arr + read_len <= ce + max_over)

    valid = hit_valid & contig_bounded(start) & (start >= -max_over)

    if k_ext:
        # verify the seed extension: genome[pos+32 : pos+k] must equal the
        # read's ext bases exactly (and carry no Ns)
        ext_pos = jnp.maximum(hit_pos + k_search, 0)      # [B, S, R]
        gp = arrays.genome_packed
        gw = gp.shape[0]
        word0 = ((ext_pos - arrays.plane_base) >> 4) + GP_PAD_WORDS
        t_idx = jnp.arange(w_ext + 1, dtype=jnp.int32)
        widx = jnp.clip(word0[..., None] + t_idx, 0, gw - 1)
        words = gp[widx]                                  # [B, S, R, We+1]
        o2 = ((ext_pos & 15) << 1).astype(jnp.uint32)[..., None]
        safe = jnp.where(o2 == 0, jnp.uint32(1), jnp.uint32(32) - o2)
        g_ext = jnp.where(o2 == 0, words[..., :-1],
                          (words[..., :-1] << o2) | (words[..., 1:] >> safe))
        xor = g_ext ^ q_ext[:, :, None, :]                # [B, S, R, We]
        # zero out bases beyond k_ext in the final word
        tail = k_ext - 16 * (w_ext - 1)
        word_mask = np.full(w_ext, 0xFFFFFFFF, np.uint64)
        word_mask[-1] = (0xFFFFFFFF << (32 - 2 * tail)) & 0xFFFFFFFF
        xor = xor & jnp.asarray(word_mask.astype(np.uint32))
        ext_eq = jnp.all(xor == 0, axis=-1)
        valid = valid & ext_eq
        if cfg.genome_has_n:
            # genome N in the ext range: check the N-bit plane word span
            gn = arrays.genome_nbits
            gnw = gn.shape[0]
            nw = -(-(k_ext + 31) // 32) + 1
            nword0 = ((ext_pos - arrays.plane_base) >> 5) + GN_PAD_WORDS
            nt = jnp.arange(nw, dtype=jnp.int32)
            nwidx = jnp.clip(nword0[..., None] + nt, 0, gnw - 1)
            nwords = gn[nwidx]
            no = (ext_pos & 31).astype(jnp.uint32)[..., None]
            nsafe = jnp.where(no == 0, jnp.uint32(1), jnp.uint32(32) - no)
            n_al = jnp.where(no == 0, nwords[..., :-1],
                             (nwords[..., :-1] << no) | (nwords[..., 1:] >> nsafe))
            nmask_words = np.zeros(nw - 1, np.uint64)
            for wi in range(nw - 1):
                span = min(32, k_ext - 32 * wi)
                if span > 0:
                    nmask_words[wi] = (0xFFFFFFFF << (32 - span)) & 0xFFFFFFFF
            n_hit = jnp.any(
                (n_al & jnp.asarray(nmask_words.astype(np.uint32))) != 0, axis=-1)
            valid = valid & ~n_hit

    diag = {"seed_match_counts": count, "seed_too_many": too_many}
    flat = lambda x: x.reshape(b, -1)
    starts_f, orients_f = [flat(start)], [flat(orient)]
    valids_f, cleans_f = [flat(valid)], [flat(clean)]

    if cfg.neighborhood_size_threshold > 0 and cfg.seed_len == 32:
        # NeighborMaskMatcher analog: for seeds with NO exact hit, scan the
        # sorted block sharing the 16-base prefix for k-mers whose 16-base
        # suffix is within Hamming distance 1 of the seed's.  XOR of the
        # biased low words cancels the order bias (both are x ^ 0x80000000),
        # then 2-bit symbol-difference + popcount — the reference's
        # areNeighbors Hamming over 2-bit chunks, fully vectorized.
        p_begin, p_count = search.sorted_prefix_range(
            arrays.key_hi, arrays.key_lo, q_hi, arrays.n_real)
        scan = cfg.neighbor_scan_cap
        # --ignore-repeats: repeat-suppressed exact matches don't block
        # the inexact pass (manual.md:405)
        not_blocked = (jnp.ones_like(too_many) if cfg.ignore_repeats
                       else ~too_many)
        eligible = (eff == 0) & not_blocked & ~seed_has_n & \
            (p_count > 0) & \
            (p_count <= min(cfg.neighborhood_size_threshold, scan))
        r2 = jnp.arange(scan, dtype=jnp.int32)
        nb_idx = p_begin[:, :, None] + r2[None, None, :]       # [B, S, SC]
        nb_idx_c = jnp.minimum(nb_idx, arrays.key_hi.shape[0] - 1)
        in_block = r2[None, None, :] < p_count[:, :, None]
        entry_lo = arrays.key_lo[nb_idx_c]
        xor = jnp.bitwise_xor(entry_lo, q_lo[:, :, None]).astype(jnp.uint32)
        sym_diff = (xor | (xor >> jnp.uint32(1))) & jnp.uint32(0x55555555)
        ham = jax.lax.population_count(sym_diff).astype(jnp.int32)
        nb_pos = arrays.pos[nb_idx_c]
        nb_ok = eligible[:, :, None] & in_block & (ham <= 1) & \
            (nb_pos != TOO_MANY_POS)
        nb_start = nb_pos - qoff_arr[None, :, None]
        nb_orient = jnp.broadcast_to(orient_arr[None, :, None], nb_start.shape)
        nb_valid = nb_ok & contig_bounded(nb_start) & (nb_start >= -max_over)
        starts_f.append(flat(nb_start))
        orients_f.append(flat(nb_orient))
        valids_f.append(flat(nb_valid))
        # a neighbor hit carries a mismatch: never a clean anchor
        cleans_f.append(flat(jnp.zeros_like(nb_ok)))
        diag["neighbor_hits"] = jnp.sum(nb_valid, axis=(1, 2))

    cat = lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs, axis=1)
    return cat(starts_f), cat(orients_f), cat(valids_f), cat(cleans_f), diag


def dedup_candidates(start_f, orient_f, valid_f, clean_f, max_candidates: int):
    """Stage B: sort-dedup hit lists, compact to [B, C].

    Reference analog: FragmentBuilder::consolidateDuplicateFragments
    (FragmentBuilder.cpp:82-346) — here a device sort + unique-scan +
    stable compaction, all fixed shape.

    Anchoring info rides the sort: within one (orient, start) run, hits
    from neighbor-free k-mers sort first (4th key), so the kept
    representative is clean iff ANY supporting hit was clean; the run
    length (support count, recovered from compacted slot indices) tells
    whether multiple seeds agree — together these reproduce the
    reference's isWellAnchored rule (TemplateBuilder.cpp:233-286).
    """
    b = start_f.shape[0]
    valid_i = valid_f.astype(jnp.int32)
    invalid_f = 1 - valid_i
    not_clean = 1 - clean_f.astype(jnp.int32)
    # lexicographic sort by (invalid, orient, start, not_clean)
    invalid_s, orient_s, start_s, not_clean_s = jax.lax.sort(
        (invalid_f, orient_f.astype(jnp.int32), start_f, not_clean),
        num_keys=4, is_stable=True)
    same_as_prev = jnp.concatenate(
        [jnp.zeros((b, 1), bool),
         (orient_s[:, 1:] == orient_s[:, :-1]) & (start_s[:, 1:] == start_s[:, :-1])],
        axis=1)
    unique = (invalid_s == 0) & (~same_as_prev)
    # per-run support counts: distance from each run head to the next run
    # head (or to the end of the valid region), via a suffix cumulative min
    big = jnp.int32(2**31 - 1)
    slot = jnp.broadcast_to(
        jnp.arange(start_s.shape[1], dtype=jnp.int32)[None, :], start_s.shape)
    head_slots = jnp.where(unique, slot, big)
    nxt_incl = jnp.flip(jax.lax.cummin(jnp.flip(head_slots, 1), axis=1), 1)
    nxt = jnp.concatenate([nxt_incl[:, 1:], jnp.full((b, 1), big, jnp.int32)],
                          axis=1)
    n_valid = jnp.sum(valid_i, axis=1, keepdims=True)
    support_s = jnp.clip(jnp.minimum(nxt, n_valid) - slot, 0, 10_000)

    # stable-compact unique entries to the front
    compact_key = jnp.where(unique, slot, big)
    _, start_u, orient_u, uniq_u, clean_u, support_u = jax.lax.sort(
        (compact_key, start_s, orient_s, unique.astype(jnp.int32),
         1 - not_clean_s, support_s),
        num_keys=1, is_stable=True)
    c = max_candidates
    num_unique = jnp.sum(unique, axis=1)
    return (start_u[:, :c], orient_u[:, :c], uniq_u[:, :c].astype(bool),
            clean_u[:, :c].astype(bool), support_u[:, :c],
            {"num_candidates": num_unique, "candidate_overflow": num_unique > c})


def _split_seed_passes(cfg: AlignConfig, read_len: int):
    """(pass1 offsets, pass2 offsets): pass 1 is the first
    `first_pass_seeds` offsets PLUS the end-flush seed, so head and tail
    anchors are both probed — a wide indel shows up as disagreement and
    escalates instead of completing on the head anchor alone."""
    offsets = [o for o in cfg.seed_offsets if o + cfg.seed_len <= read_len]
    p1 = list(dict.fromkeys(offsets[: cfg.first_pass_seeds] + offsets[-1:]))
    p2 = [o for o in offsets if o not in p1]
    return tuple(p1), tuple(p2)


def _find_hits_two_pass(arrays: IndexArrays, cfg: AlignConfig, bases,
                        find_fn=find_seed_hits):
    """Two-pass seed escalation (see AlignConfig.first_pass_seeds).

    `find_fn` abstracts the hit source: the single-device path searches
    the whole index; the SPMD path (parallel/sharded.py) searches the
    local index shard and all-gathers the hit lists over the `shard`
    mesh axis — because k-mer runs never straddle shards, the gathered
    lists hold exactly the single-index hits (modulo padding), so the
    completeness/escalation decisions here are device-count-invariant.
    """
    b = bases.shape[0]
    p1, p2 = _split_seed_passes(cfg, bases.shape[1])
    cfg1 = dataclasses.replace(cfg, seed_offsets=p1)
    s1, o1, v1, c1, diag1 = find_fn(arrays, cfg1, bases)

    # complete = has a clean exact anchor AND every valid hit projects to
    # the same (orient, start) — disagreeing anchors (indel candidates)
    # and neighbor-flagged-only reads fall through to the full seed set
    has_clean = jnp.any(v1 & c1, axis=1)
    big = jnp.int32(2**30)
    mn_s = jnp.min(jnp.where(v1, s1, big), axis=1)
    mx_s = jnp.max(jnp.where(v1, s1, -big), axis=1)
    mn_o = jnp.min(jnp.where(v1, o1, big), axis=1)
    mx_o = jnp.max(jnp.where(v1, o1, -big), axis=1)
    complete = has_clean & (mn_s == mx_s) & (mn_o == mx_o)

    incomplete = ~complete
    b2 = max(1, int(round(b * cfg.second_pass_fraction)))
    (ridx,) = jnp.nonzero(incomplete, size=b2, fill_value=b)
    rvalid = ridx < b
    sub_bases = bases[jnp.minimum(ridx, b - 1)]
    cfg2 = dataclasses.replace(cfg, seed_offsets=p2)
    s2, o2, v2, c2, _diag2 = find_fn(arrays, cfg2, sub_bases)
    v2 = v2 & rvalid[:, None]

    h2 = s2.shape[1]
    rows = jnp.where(rvalid, ridx, b)    # row b = scratch, sliced off

    def scatter(x, fill):
        base_arr = jnp.full((b + 1, h2), fill, x.dtype)
        return base_arr.at[rows].set(x, mode="drop")[:b]

    start_f = jnp.concatenate([s1, scatter(s2, 0)], axis=1)
    orient_f = jnp.concatenate([o1, scatter(o2, 0)], axis=1)
    valid_f = jnp.concatenate([v1, scatter(v2, False)], axis=1)
    clean_f = jnp.concatenate([c1, scatter(c2, False)], axis=1)
    n_inc = jnp.sum(incomplete.astype(jnp.int32))
    diag1["pass2_reads"] = n_inc
    diag1["pass2_dropped"] = jnp.maximum(n_inc - b2, 0)
    # per-read mask of reads whose pass-2 escalation was dropped by the
    # sub-batch capacity: their candidate sets are incomplete, so they are
    # forced through the dodgy (MAPQ-0) path instead of silently keeping
    # an overconfident pass-1-only score
    diag1["pass2_dropped_mask"] = incomplete & \
        (jnp.cumsum(incomplete.astype(jnp.int32)) > b2)
    return start_f, orient_f, valid_f, clean_f, diag1


def _gather_candidates(arrays: IndexArrays, cfg: AlignConfig, bases, _quals,
                       find_fn=find_seed_hits):
    """Stages A+B fused (single-device or, via find_fn, per-shard SPMD)."""
    _p1, p2 = _split_seed_passes(cfg, bases.shape[1])
    if cfg.first_pass_seeds > 0 and p2:
        start_f, orient_f, valid_f, clean_f, diag_a = _find_hits_two_pass(
            arrays, cfg, bases, find_fn)
    else:
        start_f, orient_f, valid_f, clean_f, diag_a = find_fn(
            arrays, cfg, bases)
    cand_start, cand_orient, cand_valid, cand_clean, support, diag_b = \
        dedup_candidates(start_f, orient_f, valid_f, clean_f, cfg.max_candidates)
    # well anchored: a neighbor-free seed supports it, or several seeds agree
    well_anchored = cand_clean | (support >= 2)
    diag = {**diag_a, **diag_b}
    # score only the leading slots; anything past the cap is untrackable
    # repeat mass -> scored_overflow forces MAPQ 0 downstream
    k = min(cfg.max_scored_candidates, cfg.max_candidates)
    diag["scored_overflow"] = diag["num_candidates"] > k
    sl = lambda x: x[:, :k]
    return sl(cand_start), sl(cand_orient), sl(cand_valid), \
        sl(well_anchored), diag


def _score_ungapped(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
                    cand_start, cand_orient, cand_valid):
    """Vectorized ungapped scoring of every (read, candidate) pair.

    Reference semantics: UngappedAligner::alignUngapped +
    AlignerBase::updateFragmentCigar (UngappedAligner.cpp:39-96,
    AlignerBase.cpp:121-231): per-base log-prob accumulation with the
    isMatch rule, mismatch count, edit distance (mismatches + Ns).

    Memory-bandwidth formulation: instead of one random
    gather per (candidate, base), gather ceil(L/16)+1 PACKED 2-bit words
    per candidate, funnel-shift them into read alignment with per-element
    variable shifts, XOR against the packed read, and expand the 16 lanes
    of each XOR word with static shifts — all element-wise work.
    The per-base log-prob decomposes as
        lp = sum_j logMatch[q_j] + sum_{non-match j} (logMismatch-logMatch)[q_j]
    so the only table gathers are per READ (not per candidate).
    """
    b, read_len = bases.shape
    c = cand_start.shape[1]
    w_read = -(-read_len // 16)

    rc_bases = bitops.revcomp_reads(bases)
    r_quals = bitops.reverse_quals(quals)

    # per-read, per-orientation precomputation: packed words, N mask,
    # all-match log prob, per-base penalty delta
    packed_fwd = pack_reads(bases)                  # [B, Wr]
    packed_rev = pack_reads(rc_bases)
    t_match, t_mismatch = quality.log_tables()

    def per_orient(base_arr, qual_arr):
        qi = qual_arr.astype(jnp.int32)
        lm = t_match[qi]                            # [B, L]
        delta = t_mismatch[qi] - lm
        n_mask = base_arr >= dna.NUM_BASES
        return lm, delta, n_mask

    lm_f, delta_f, n_f = per_orient(bases, quals)
    lm_r, delta_r, n_r = per_orient(rc_bases, r_quals)

    # ---- compact valid (read, candidate) pairs into a dense work queue
    flat_valid = cand_valid.reshape(-1)                           # [B*C]
    n_flat = b * c
    p = min(getattr(cfg, "scored_pairs_per_read", 4) * b, n_flat)
    (pair_idx,) = jnp.nonzero(flat_valid, size=p, fill_value=n_flat)
    pvalid = pair_idx < n_flat
    safe_idx = jnp.minimum(pair_idx, n_flat - 1)
    row = safe_idx // c                                           # [P]
    p_start = cand_start.reshape(-1)[safe_idx]
    p_rc = cand_orient.reshape(-1)[safe_idx] == 1
    # reads whose valid pairs overflow the queue (forced MAPQ 0 upstream)
    cum = jnp.cumsum(flat_valid.astype(jnp.int32))
    dropped_row = jnp.any(
        (flat_valid & (cum > p)).reshape(b, c), axis=1)

    # per-position in-contig mask: positions overhanging the candidate's
    # contig (located by the read's MIDDLE base) are soft-clipped —
    # excluded from mismatch/edit counts and probability mass
    # (AlignerBase.cpp:121-231)
    mid = p_start + read_len // 2
    p_cid = jnp.clip(
        jnp.searchsorted(arrays.contig_starts, mid, side="right") - 1,
        0, arrays.contig_starts.shape[0] - 1)
    c_lo = arrays.contig_starts[p_cid][:, None]                   # [P, 1]
    c_hi = arrays.contig_ends[p_cid][:, None]
    pos_j = p_start[:, None] + jnp.arange(read_len, dtype=jnp.int32)[None, :]
    in_contig = (pos_j >= c_lo) & (pos_j < c_hi)                  # [P, L]

    # gather packed genome windows: Wr+1 words starting at start>>4
    gp = arrays.genome_packed
    gw = gp.shape[0]
    word0 = ((p_start - arrays.plane_base) >> 4) + GP_PAD_WORDS   # [P]
    t_idx = jnp.arange(w_read + 1, dtype=jnp.int32)
    widx = jnp.clip(word0[:, None] + t_idx[None, :], 0, gw - 1)
    words = gp[widx]                                              # [P, Wr+1]

    # funnel-shift into read phase: o2 = 2*(start % 16) bits
    o2 = ((p_start & 15) << 1).astype(jnp.uint32)[:, None]        # [P, 1]
    lo_words = words[:, :-1]
    hi_words = words[:, 1:]
    safe = jnp.where(o2 == 0, jnp.uint32(1), jnp.uint32(32) - o2)
    aligned = jnp.where(o2 == 0, lo_words,
                        (lo_words << o2) | (hi_words >> safe))    # [P, Wr]

    read_words = jnp.where(p_rc[:, None], packed_rev[row], packed_fwd[row])
    x = aligned ^ read_words                                      # [P, Wr]

    # expand 16 two-bit lanes per word with static shifts
    lane_shifts = jnp.asarray((2 * (15 - np.arange(16))).astype(np.uint32))
    lanes = (x[:, :, None] >> lane_shifts[None, None, :]) & jnp.uint32(3)
    code_mismatch = (lanes != 0).reshape(p, w_read * 16)[:, :read_len]

    # genome N bits: gather + align on the 1-bit plane (skipped entirely
    # for N-free genomes — a static property of the index)
    if cfg.genome_has_n:
        gn = arrays.genome_nbits
        gnw = gn.shape[0]
        w_n = -(-(read_len + 31) // 32) + 1
        nword0 = ((p_start - arrays.plane_base) >> 5) + GN_PAD_WORDS
        nt = jnp.arange(w_n, dtype=jnp.int32)
        nwidx = jnp.clip(nword0[:, None] + nt[None, :], 0, gnw - 1)
        nwords = gn[nwidx]
        no = (p_start & 31).astype(jnp.uint32)[:, None]
        nsafe = jnp.where(no == 0, jnp.uint32(1), jnp.uint32(32) - no)
        naligned = jnp.where(no == 0, nwords[:, :-1],
                             (nwords[:, :-1] << no) | (nwords[:, 1:] >> nsafe))
        nlane_shifts = jnp.asarray((31 - np.arange(32)).astype(np.uint32))
        nlanes = (naligned[:, :, None] >> nlane_shifts[None, None, :]) & jnp.uint32(1)
        ref_n = (nlanes != 0).reshape(p, (w_n - 1) * 32)[:, :read_len]
    else:
        ref_n = jnp.zeros((p, read_len), bool)

    read_n = jnp.where(p_rc[:, None], n_r[row], n_f[row])         # [P, L]

    # reference isMatch: read N matches; otherwise equal codes and ref not N
    is_match = read_n | (~code_mismatch & ~ref_n)
    p_mismatches = jnp.sum(~is_match & in_contig, axis=-1).astype(jnp.int32)
    p_edit = jnp.sum((read_n | ref_n | code_mismatch) & in_contig,
                     axis=-1).astype(jnp.int32)

    delta = jnp.where(p_rc[:, None], delta_r[row], delta_f[row])
    lm = jnp.where(p_rc[:, None], lm_r[row], lm_f[row])
    p_log_prob = jnp.sum(
        jnp.where(in_contig, jnp.where(is_match, lm, lm + delta), 0.0),
        axis=-1)

    # ---- scatter back to the [B, C] grid (invalid slots -> -inf / 0)
    neg_inf = jnp.float32(-jnp.inf)
    scatter_idx = jnp.where(pvalid, pair_idx, n_flat)
    log_prob = jnp.full(n_flat, neg_inf, jnp.float32) \
        .at[scatter_idx].set(p_log_prob, mode="drop").reshape(b, c)
    mismatches = jnp.zeros(n_flat, jnp.int32) \
        .at[scatter_idx].set(p_mismatches, mode="drop").reshape(b, c)
    edit_distance = jnp.zeros(n_flat, jnp.int32) \
        .at[scatter_idx].set(p_edit, mode="drop").reshape(b, c)
    return log_prob, mismatches, edit_distance, dropped_row


def score_candidates(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
                     cand_start, cand_orient, cand_valid, well_anchored,
                     num_candidates, scored_overflow,
                     pass2_dropped_mask=None, finder_stats=None,
                     score_fn=None):
    """Stage C on an already-gathered candidate grid -> per-end dict.

    Split out of score_end so the SPMD path (parallel/sharded.py) can
    feed candidates assembled from per-shard hit lists into the same
    scorer/pair machinery.  `score_fn` abstracts the window scorer: the
    genome-sharded mode scores owned candidates per shard and psums.
    """
    b, read_len = bases.shape
    log_prob, mismatches, edit_distance, dropped = (score_fn or _score_ungapped)(
        arrays, cfg, bases, quals, cand_start, cand_orient, cand_valid)
    # locate by the middle base: edge-overhanging candidates still belong
    # to the contig that holds most of the read
    cid = jnp.searchsorted(arrays.contig_starts,
                           cand_start + read_len // 2, side="right") - 1
    cid = jnp.clip(cid, 0, arrays.contig_starts.shape[0] - 1)
    dodgy = scored_overflow | dropped
    if pass2_dropped_mask is not None:
        dodgy = dodgy | pass2_dropped_mask
    return {
        "score_dropped": dropped,
        # untrackable repeat mass (or a dropped pass-2 escalation): force
        # dodgy handling in the pair resolver like finalize_single_end does
        "dodgy": dodgy,
        "start": cand_start,
        "orient": cand_orient,
        "valid": cand_valid,
        "well_anchored": well_anchored,
        "cid": jnp.where(cand_valid, cid, -1),
        "log_prob": log_prob,
        "sw_score": mismatches,          # ungapped SW score == mismatch count
        "mismatches": mismatches,
        "edit": edit_distance,
        "obs_len": jnp.full(cand_start.shape, read_len, jnp.int32),
        "num_candidates": num_candidates,
        "finder_stats": finder_stats or {},
    }


def score_end(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
              find_fn=find_seed_hits, score_fn=None):
    """Stages A+B+C for one read end: deduped, scored candidate lists.

    Returns the per-end dict consumed by the pair resolver
    (align/pairs.py): start, orient, valid, cid, log_prob, sw_score,
    edit, obs_len — all [B, C].
    """
    cand_start, cand_orient, cand_valid, well_anchored, diag = _gather_candidates(
        arrays, cfg, bases, quals, find_fn)
    return score_candidates(
        arrays, cfg, bases, quals, cand_start, cand_orient, cand_valid,
        well_anchored, diag["num_candidates"], diag["scored_overflow"],
        pass2_dropped_mask=diag.get("pass2_dropped_mask"),
        finder_stats=_finder_stats_from_diag(diag), score_fn=score_fn)


def quality_trim_device(bases, quals, cutoff: int, tail_masked):
    """On-device 3' quality trim — the exact math of the host
    clippers.quality_trim_batch (reference trimLowQualityEnd,
    lib/alignment/Quality.cpp:72-120): walk leftward from the unmasked 3'
    end accumulating (cutoff - q), stop at the first negative sum, trim
    through the first running-max position when the peak is positive.

    Returns (masked bases, masked quals, per-read trim counts int32 [B]).
    """
    from .clippers import MASK_READ_LENGTH_MIN
    b, l = bases.shape
    if cutoff <= 0 or l < MASK_READ_LENGTH_MIN:
        return bases, quals, jnp.zeros(b, jnp.int32)
    start_j = jnp.int32(l - 1) - tail_masked.astype(jnp.int32)   # [B]
    t = jnp.arange(l, dtype=jnp.int32)[None, :]
    j = start_j[:, None] - t                                     # [B, L]
    in_walk = j >= MASK_READ_LENGTH_MIN
    qv = jnp.take_along_axis(quals.astype(jnp.int32), jnp.maximum(j, 0),
                             axis=1)
    qs = jnp.cumsum(jnp.where(in_walk, jnp.int32(cutoff) - qv, 0), axis=1)
    stopped = (qs < 0) | ~in_walk
    alive = jnp.cumsum(stopped.astype(jnp.int32), axis=1) == 0
    qs_m = jnp.where(alive, qs, jnp.iinfo(jnp.int32).min)
    peak = jnp.max(qs_m, axis=1)
    t_peak = jnp.argmax(qs_m, axis=1).astype(jnp.int32)          # first max
    trims = jnp.where(peak > 0, t_peak + 1, 0).astype(jnp.int32)
    cut_from = start_j + 1 - trims
    col = t
    mask = (col >= cut_from[:, None]) & (col <= start_j[:, None]) & \
        (trims[:, None] > 0)
    bases = jnp.where(mask, jnp.uint8(dna.N), bases)
    quals = jnp.where(mask, jnp.uint8(0), quals)
    return bases, quals, trims


def semialigned_clip_device(arrays: IndexArrays, cfg: AlignConfig, bases,
                            start, rev, aligned, trims):
    """On-device semialigned-ends clip for the chosen ungapped placement.

    Reference analog: SemialignedEndsClipper (lib/alignment/matchSelector/
    SemialignedEndsClipper.cpp) — soft-clip aligned ends inward until
    CONSECUTIVE_MATCHES_MIN consecutive matches.  `bases` must be the
    (trim-masked) batch the scorer saw; `start`/`rev`/`aligned` the chosen
    placement; `trims` the total 3' mask counts (adapter + quality).

    Emits per-read: sa_do (clip fires), sa_lead/sa_tail (FINAL soft-clip
    spans incl. trim + contig overhang), sa_removed (mismatches clipped
    away), sa_pos (final genome start).  The host rewrites CIGARs for
    sa_do rows whose final cigar carries no indels
    (clippers.apply_semialigned_device); rows later replaced by gapped
    polish keep their realigned ends, like the reference.
    """
    from .clippers import CONSECUTIVE_MATCHES_MIN
    b, l = bases.shape
    w_read = -(-l // 16)
    g = genome_len_of(arrays, cfg)
    start = jnp.where(aligned, start, 0).astype(jnp.int32)
    rev = rev.astype(bool)

    rc = bitops.revcomp_reads(bases)
    seq = jnp.where(rev[:, None], rc, bases)
    packed = pack_reads(seq)

    gp = arrays.genome_packed
    gw = gp.shape[0]
    word0 = ((start - arrays.plane_base) >> 4) + GP_PAD_WORDS
    t_idx = jnp.arange(w_read + 1, dtype=jnp.int32)
    widx = jnp.clip(word0[:, None] + t_idx[None, :], 0, gw - 1)
    words = gp[widx]
    o2 = ((start & 15) << 1).astype(jnp.uint32)[:, None]
    safe = jnp.where(o2 == 0, jnp.uint32(1), jnp.uint32(32) - o2)
    g_aligned = jnp.where(o2 == 0, words[:, :-1],
                          (words[:, :-1] << o2) | (words[:, 1:] >> safe))
    x = g_aligned ^ packed
    lane_shifts = jnp.asarray((2 * (15 - np.arange(16))).astype(np.uint32))
    lanes = (x[:, :, None] >> lane_shifts[None, None, :]) & jnp.uint32(3)
    code_mismatch = (lanes != 0).reshape(b, w_read * 16)[:, :l]

    if cfg.genome_has_n:
        gn = arrays.genome_nbits
        gnw = gn.shape[0]
        w_n = -(-(l + 31) // 32) + 1
        nword0 = ((start - arrays.plane_base) >> 5) + GN_PAD_WORDS
        nt = jnp.arange(w_n, dtype=jnp.int32)
        nwidx = jnp.clip(nword0[:, None] + nt[None, :], 0, gnw - 1)
        nwords = gn[nwidx]
        no = (start & 31).astype(jnp.uint32)[:, None]
        nsafe = jnp.where(no == 0, jnp.uint32(1), jnp.uint32(32) - no)
        naligned = jnp.where(no == 0, nwords[:, :-1],
                             (nwords[:, :-1] << no) | (nwords[:, 1:] >> nsafe))
        nlane_shifts = jnp.asarray((31 - np.arange(32)).astype(np.uint32))
        nlanes = (naligned[:, :, None] >> nlane_shifts[None, None, :]) \
            & jnp.uint32(1)
        ref_n = (nlanes != 0).reshape(b, (w_n - 1) * 32)[:, :l]
    else:
        ref_n = jnp.zeros((b, l), bool)

    read_n = seq >= dna.NUM_BASES
    match = read_n | (~code_mismatch & ~ref_n)

    col = jnp.arange(l, dtype=jnp.int32)[None, :]
    pos_j = start[:, None] + col
    in_genome = (pos_j >= 0) & (pos_j < g)

    mid = start + l // 2
    cid = jnp.clip(
        jnp.searchsorted(arrays.contig_starts, mid, side="right") - 1,
        0, arrays.contig_starts.shape[0] - 1)
    lead_c = jnp.clip(arrays.contig_starts[cid] - start, 0, l)
    tail_c = jnp.clip(start + l - arrays.contig_ends[cid], 0, l)
    trims = trims.astype(jnp.int32)
    lead = lead_c + jnp.where(rev, trims, 0)
    tail = tail_c + jnp.where(rev, 0, trims)

    core = (col >= lead[:, None]) & (col < l - tail[:, None]) & in_genome
    ok = match & core
    mism = ~match & core

    k = CONSECUTIVE_MATCHES_MIN

    def first_run_start(okm):
        idx = jnp.broadcast_to(col, okm.shape)
        last_false = jax.lax.cummax(jnp.where(~okm, idx, -1), axis=1)
        runlen = idx - last_false
        hit = runlen >= k
        any_hit = jnp.any(hit, axis=1)
        j0 = jnp.argmax(hit, axis=1).astype(jnp.int32)
        return jnp.where(any_hit, j0 - (k - 1), 0)

    left = jnp.maximum(first_run_start(ok) - lead, 0)
    right = jnp.maximum(first_run_start(ok[:, ::-1]) - tail, 0)
    core_len = l - tail - lead
    do = ((left > 0) | (right > 0)) & (left + right + k < core_len) & aligned
    left_mm = jnp.sum(mism & (col < (lead + left)[:, None]), axis=1)
    right_mm = jnp.sum(mism & (col >= (l - tail - right)[:, None]), axis=1)
    return {
        "sa_do": do,
        "sa_lead": (lead + left).astype(jnp.int32),
        "sa_tail": (tail + right).astype(jnp.int32),
        "sa_removed": jnp.where(do, left_mm + right_mm, 0).astype(jnp.int32),
        "sa_pos": (start + lead + left).astype(jnp.int32),
    }


def align_batch(arrays: IndexArrays, bases: jax.Array, quals: jax.Array,
                cfg: AlignConfig, tail_masked=None, find_fn=find_seed_hits,
                score_fn=None, clip_fn=None):
    """Jittable single-end alignment of one read batch.

    Args:
      arrays: device index (IndexArrays pytree).
      bases: uint8 [B, L] read base codes.
      quals: uint8 [B, L] phred scores.
      cfg:   static AlignConfig.
      tail_masked: optional int32 [B] 3' bases already masked on the host
        (adapter clipping) — the on-device quality trim resumes left of
        them when cfg.quality_trim_cutoff is set.

    Returns a dict of [B]-shaped result arrays (all fixed shape):
      aligned, start (global genome pos), reverse, mapq, mismatches,
      edit_distance, log_prob, num_candidates, candidate_overflow
      (+ qtrim / sa_* when device trimming/clipping is enabled).
    """
    b, read_len = bases.shape
    if tail_masked is None:
        tail_masked = jnp.zeros(b, jnp.int32)
    qtrim = jnp.zeros(b, jnp.int32)
    if cfg.quality_trim_cutoff > 0:
        bases, quals, qtrim = quality_trim_device(
            bases, quals, cfg.quality_trim_cutoff, tail_masked)
    cand_start, cand_orient, cand_valid, well_anchored, diag = _gather_candidates(
        arrays, cfg, bases, quals, find_fn)
    res = finalize_single_end(arrays, cfg, bases, quals,
                              cand_start, cand_orient, cand_valid, diag,
                              well_anchored, score_fn=score_fn)
    res["qtrim"] = qtrim
    if cfg.semialigned_clip:
        res.update((clip_fn or semialigned_clip_device)(
            arrays, cfg, bases, res["start"], res["reverse"], res["aligned"],
            tail_masked + qtrim))
    return res


def finalize_single_end(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
                        cand_start, cand_orient, cand_valid, diag,
                        well_anchored=None, score_fn=None):
    """Stages C+D: score candidates, pick best, MAPQ (single-end)."""
    _b, read_len = bases.shape
    log_prob, mismatches, edit_distance, dropped = (score_fn or _score_ungapped)(
        arrays, cfg, bases, quals, cand_start, cand_orient, cand_valid)

    # best candidate: lowest mismatch count ("smith-waterman score" of the
    # ungapped path), then highest log-prob (TemplateBuilder::getBestFragment)
    order_key = jnp.where(cand_valid,
                          mismatches.astype(jnp.float32) * jnp.float32(1e6) - log_prob,
                          jnp.float32(jnp.inf))
    if cfg.scatter_repeats:
        # exact-tie placements (identical repeat copies score bitwise
        # equal) pick by hash instead of lowest genome position
        kmin = jnp.min(order_key, axis=1, keepdims=True)
        tie = cand_valid & (order_key <= kmin)
        row = jnp.arange(order_key.shape[0], dtype=jnp.int32)[:, None]
        h = scatter_hash(jnp.broadcast_to(row, cand_start.shape),
                         cand_start, cand_orient)
        best = jnp.argmax(jnp.where(tie, h, -1), axis=1)
    else:
        best = jnp.argmin(order_key, axis=1)                     # [B]
    take = lambda x: jnp.take_along_axis(x, best[:, None], axis=1)[:, 0]

    aligned = jnp.any(cand_valid, axis=1)
    best_lp = take(log_prob)
    # exp(-m)-scaled masses: raw f32 exponentials underflow for
    # high-mismatch placements (lp < ~-87) and the rog prior underflows
    # past ~60bp reads; the reference computes these in double
    # (TemplateBuilder.cpp:233-286)
    total_s, p_best_s, m_scale = quality.scaled_masses(
        log_prob, cand_valid, best_lp)
    others_sum = jnp.maximum(total_s - p_best_s, 0.0)

    log_rog = quality.log_rest_of_genome_correction(
        genome_len_of(arrays, cfg), read_len)
    mapq_f = quality.mapping_quality_scaled(
        total_s, p_best_s, quality.rog_scaled(log_rog, m_scale))
    mapq = jnp.clip(jnp.floor(mapq_f), 0, cfg.mapq_cap).astype(jnp.int32)
    mapq = jnp.where(aligned, mapq, 0)
    dodgy = dropped
    if diag.get("scored_overflow") is not None:
        # more distinct placements than the scoring cap: dodgy repeat
        dodgy = dodgy | diag["scored_overflow"]
    if diag.get("pass2_dropped_mask") is not None:
        # dropped pass-2 escalation: candidate set incomplete
        dodgy = dodgy | diag["pass2_dropped_mask"]
    mapq = jnp.where(dodgy, jnp.int32(cfg.dodgy_mapq), mapq)
    if cfg.dodgy_unaligned:
        aligned = aligned & ~dodgy
    if well_anchored is not None:
        # all supporting seeds have neighbors and no two agree -> score 0
        # (TemplateBuilder::updateMappingScore else-branch)
        mapq = jnp.where(take(well_anchored.astype(jnp.int32)) == 1, mapq, 0)

    return {
        **_finder_stats_from_diag(diag),
        "aligned": aligned,
        "start": jnp.where(aligned, take(cand_start), -1),
        "reverse": take(cand_orient) == 1,
        "mapq": mapq,
        "mismatches": take(mismatches),
        "edit_distance": take(edit_distance),
        "log_prob": best_lp,
        # neighborhood probability mass (non-best candidates), SCALED by
        # exp(-log_scale) — hosts recover the raw f64 mass as
        # others_sum * exp(log_scale); lets the host re-derive MAPQ after
        # gapped polish updates the best lp
        "others_sum": others_sum,
        "log_scale": m_scale,
        "num_candidates": diag["num_candidates"],
        "candidate_overflow": diag["candidate_overflow"],
        # full candidate lists: the host-side long-indel polish pairs up
        # disagreeing anchors (reference SimpleIndelAligner semantics)
        "cand_start": cand_start,
        "cand_orient": cand_orient,
        "cand_valid": cand_valid,
        "cand_mismatches": mismatches,
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def align_batch_jit(arrays: IndexArrays, bases, quals, cfg: AlignConfig,
                    tail_masked=None):
    return align_batch(arrays, bases, quals, cfg, tail_masked)


def mask_tail_device(bases, quals, tail_masked):
    """Mask the last `tail_masked` columns of each row (N / qual 0) — the
    device-side equivalent of the host adapter mask, reconstructed from
    the per-read counts so the upload can carry ORIGINAL bases (the
    output path needs them un-masked for SAM SEQ)."""
    b, l = bases.shape
    col = jnp.arange(l, dtype=jnp.int32)[None, :]
    m = col >= (jnp.int32(l) - tail_masked.astype(jnp.int32))[:, None]
    return (jnp.where(m, jnp.uint8(dna.N), bases),
            jnp.where(m, jnp.uint8(0), quals))


# ---------------------------------------------------------------------------
# Packed result transfer
# ---------------------------------------------------------------------------
# Every fetched buffer is one device-to-host copy with its own sync, and a
# result dict holds ~26 arrays of a few MB in all.  pack_device_result
# concatenates every array into one int32 vector + one uint8 vector ON
# DEVICE; the host fetches two buffers and re-slices.
# (Reference analog: MatchSelector keeps results in one contiguous fragment
# buffer rather than per-field allocations, FragmentCollector.hh.)

def compact_cand_result(res: dict, suffix: str = "", cap_div: int = 8,
                        trigger: int = 5):
    """Shrink the fetched payload: the full [B, C] candidate planes are
    only consumed by the host long-indel polish, which examines rows
    still carrying > trigger mismatches — compact those rows into a
    [B/cap_div, C] block plus a row-index map, cutting the device->host
    traffic by ~2x (~256 B/read of candidate planes against ~80 B of
    core fields).  Rows beyond the
    static capacity are counted in cand_dropped (surfaced via
    MatchFinderStats) and skip the OPTIONAL indel polish — never a
    wrong result, only a missed improvement, and only in pathological
    all-high-mismatch batches.  `trigger` must stay <= the host indel
    trigger (max(6, gapped_mismatches+1) > 5 always)."""
    if "cand_start" + suffix not in res:
        return res
    b = res["aligned" + suffix].shape[0]
    bc = min(max(b // cap_div, 8), b)
    need = res["aligned" + suffix] & (res["mismatches" + suffix] > trigger)
    if "disjoined" in res:
        # disjoined-replaced ends may exceed the trigger only after the
        # host rescue merge — keep their candidate rows fetchable
        need = need | res["disjoined"]
    (rows,) = jnp.nonzero(need, size=bc, fill_value=b)
    ok = rows < b
    safe = jnp.minimum(rows, b - 1)
    res["cand_rows" + suffix] = jnp.where(ok, rows, -1).astype(jnp.int32)
    for nm in ("cand_start", "cand_orient", "cand_valid", "cand_mismatches"):
        k = nm + suffix
        if k in res:
            res[k] = res[k][safe]
    res["cand_dropped" + suffix] = jnp.maximum(
        jnp.sum(need.astype(jnp.int32)) - bc, 0)
    return res


def pack_device_result(res: dict):
    """Inside jit: dict of arrays -> ONE int32 vector, sorted-key order.
    float32/uint32 are bitcast (lossless); smaller ints widen; uint8
    arrays pack 4-per-word at the tail.  ONE buffer means ONE host fetch
    per batch, whatever the number of result fields."""
    i32, u8 = [], []
    for k in sorted(res):
        a = res[k]
        if a.dtype == jnp.uint8:
            u8.append(a.reshape(-1))
        elif a.dtype in (jnp.float32, jnp.uint32):
            i32.append(jax.lax.bitcast_convert_type(a, jnp.int32).reshape(-1))
        else:
            i32.append(a.astype(jnp.int32).reshape(-1))
    iv = jnp.concatenate(i32) if i32 else jnp.zeros(0, jnp.int32)
    uv = jnp.concatenate(u8) if u8 else jnp.zeros(0, jnp.uint8)
    pad = (-uv.shape[0]) % 4
    if pad:
        uv = jnp.concatenate([uv, jnp.zeros(pad, jnp.uint8)])
    uw = jax.lax.bitcast_convert_type(uv.reshape(-1, 4), jnp.int32) \
        if uv.shape[0] else jnp.zeros(0, jnp.int32)
    return jnp.concatenate([iv, uw])


def result_spec(res: dict) -> dict:
    """Host side: key -> (shape, dtype) from the (unfetched) device result
    dict a packed jit returns alongside the vectors."""
    return {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in res.items()}


def unpack_device_result(spec: dict, buf: np.ndarray) -> dict:
    """Rebuild the host result dict from the single fetched vector.
    int32/float32/uint32 values are writable views into the buffer (one
    memcpy — device_get returns read-only memory and downstream passes
    mutate results in place); bools and narrow ints restore by a cast;
    uint8 fields view the packed word tail."""
    if not buf.flags.writeable:
        buf = buf.copy()
    n_i32 = 0
    n_u8 = 0
    for shape, dtype in spec.values():
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dtype == np.uint8:
            n_u8 += n
        else:
            n_i32 += n
    i32 = buf[:n_i32]
    u8 = buf[n_i32:].view(np.uint8)[:n_u8]
    out, oi, ou = {}, 0, 0
    for k in sorted(spec):
        shape, dtype = spec[k]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dtype == np.uint8:
            out[k] = u8[ou:ou + n].reshape(shape)
            ou += n
        elif dtype in (np.float32, np.uint32):
            out[k] = i32[oi:oi + n].view(dtype).reshape(shape)
            oi += n
        else:
            v = i32[oi:oi + n].reshape(shape)
            out[k] = v if dtype == np.int32 else v.astype(dtype)
            oi += n
    return out
