"""SPMD alignment over a (data, shard) device mesh.

Design (SURVEY.md §5.8):

- `data` axis: read batches are split across devices (the reference's
  tile/cluster data parallelism, MatchSelector.cpp:279-291).
- `shard` axis: the sorted (k-mer, position) index is RANGE-sharded into
  equal record counts, split at k-mer boundaries so one k-mer's hit run
  never straddles shards (the reference's mask-file sharding axis,
  SortReference.mk:54-84, re-mapped from disk files onto device planes).
- Each device binary-searches its local shard for ALL of its data-row's
  seeds; per-shard hit lists are concatenated with an all_gather over the
  `shard` axis, then dedup + scoring + MAPQ run replicated
  on the shard axis.  Seed search cost is O(log(N/s)) per shard, and hit
  capacity per shard stays the full R so repeats clustered in one shard
  are not truncated.
- The genome plane is replicated (small-genome regime); `GenomeShards`
  position-shards the packed planes for the whole-genome regime beyond
  one device's memory
  (owner-masked scoring + psum combine).

COMMUNICATION per data-row batch of B reads with S index shards (sizes
from the shapes; times not measured on the GPU):

* hit all-gather (_gathered_find): each shard contributes its local hit
  lists (start, orient, valid, clean) of [B, H] with H = n_seeds x
  max_hits_per_seed (~80 for 2x100bp, 4 offsets x 2 orients x 10), i.e.
  ~10 B/entry -> B x H x 10 ~ 26 MB gathered per 32k-row batch.  Each
  shard's share shrinks as 1/S while search work shrinks log-fast.  The
  mesh is a plain (data, shard) reshape of the device list: every card
  of a host reaches every other at the same rate.
* scalar stats psum: O(10) scalars — noise.
* collective dedup (Build phase): every record routes to its anchor's
  owner via all_to_all — one 40-byte key tuple per record each way
  (~5 MB per 64k-record bin), overlapped with host bin IO by the Build
  pipeline.
* genome-sharded mode adds NO extra comm in steady state: candidates
  are replicated after the hit gather; owner-masked psum of the score
  grids replaces a broadcast of genome planes (the psum payload is the
  [P, 3]-ish score grid, ~1 MB/batch).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align.pipeline import (AlignConfig, IndexArrays, align_batch,
                              build_bucket_table, choose_bucket_width,
                              find_seed_hits, mask_tail_device, pack_genome)
from ..index.build import SeedIndex, TOO_MANY_POS
from ..ops import search


class ShardedIndexArrays(NamedTuple):
    """Index planes with a leading shard dimension [S, m]."""

    key_hi: jax.Array       # int32 [S, m] each row sorted, padded with I32_MAX
    key_lo: jax.Array       # int32 [S, m]
    pos: jax.Array          # int32 [S, m]
    n_real: jax.Array       # int32 [S, 1] real records per shard
    genome: jax.Array       # uint8 [G] replicated
    genome_packed: jax.Array  # uint32, replicated (see pipeline.pack_genome)
    genome_nbits: jax.Array
    contig_starts: jax.Array
    contig_ends: jax.Array
    has_neighbors: jax.Array  # uint8 [S, m]
    bucket_starts: jax.Array  # int32 [S, 2^width + 1]; width follows
                              # choose_bucket_width(index.num_records) so
                              # cfgs built via bucket_params_for match
    key_mids: tuple = ()    # 64-mer middle planes (int32 [S, m] each);
                            # empty for 16/32-mer indexes


def make_mesh(n_devices: int | None = None, data: int | None = None,
              shard: int | None = None) -> Mesh:
    """Build a (data, shard) mesh over the first n_devices devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if data is None and shard is None:
        # favor index sharding (HBM capacity) over data parallelism
        shard = 1
        while shard * 2 <= n and (n // (shard * 2)) * (shard * 2) == n:
            shard *= 2
        data = n // shard
    elif data is None:
        data = n // shard
    elif shard is None:
        shard = n // data
    assert data * shard == n, (data, shard, n)
    dev_array = np.array(devices[:n]).reshape(data, shard)
    return Mesh(dev_array, ("data", "shard"))


def shard_index(index: SeedIndex, num_shards: int) -> ShardedIndexArrays:
    """Range-shard the sorted index into `num_shards` k-mer-aligned pieces.

    Split points advance to the next k-mer boundary so all records of one
    k-mer live in exactly one shard (keeps per-shard repeat_threshold
    semantics identical to the unsharded index).
    """
    n = index.num_records
    hi, lo = index.key_hi, index.key_lo
    mids = index.key_mids
    words = (hi, *mids, lo)
    bounds = [0]
    for s in range(1, num_shards):
        cut = min(n, s * n // num_shards)
        # advance cut while it would split a k-mer run
        while 0 < cut < n and all(w[cut] == w[cut - 1] for w in words):
            cut += 1
        bounds.append(max(cut, bounds[-1]))
    bounds.append(n)

    lengths = [bounds[i + 1] - bounds[i] for i in range(num_shards)]
    m = search.pad_pow2(max(max(lengths), 1))
    i32max = np.int32(2**31 - 1)
    key_hi = np.full((num_shards, m), i32max, np.int32)
    key_lo = np.full((num_shards, m), i32max, np.int32)
    key_mids = [np.full((num_shards, m), i32max, np.int32) for _ in mids]
    pos = np.full((num_shards, m), TOO_MANY_POS, np.int32)
    nb = np.zeros((num_shards, m), np.uint8)
    n_real = np.zeros((num_shards, 1), np.int32)
    nb_src = (index.has_neighbors if index.has_neighbors is not None
              else np.zeros(n, np.uint8))
    for s in range(num_shards):
        b, e = bounds[s], bounds[s + 1]
        key_hi[s, : e - b] = hi[b:e]
        key_lo[s, : e - b] = lo[b:e]
        for km, src in zip(key_mids, mids):
            km[s, : e - b] = src[b:e]
        pos[s, : e - b] = index.pos[b:e]
        nb[s, : e - b] = nb_src[b:e]
        n_real[s, 0] = e - b

    width = choose_bucket_width(index.num_records)
    buckets = np.zeros((num_shards, (1 << width) + 1), np.int32)
    for s in range(num_shards):
        buckets[s], _ = build_bucket_table(key_hi[s, : n_real[s, 0]], width)

    contigs = index.genome.contigs
    packed, nbits = pack_genome(index.genome.codes)
    return ShardedIndexArrays(
        bucket_starts=jnp.asarray(buckets),
        key_hi=jnp.asarray(key_hi),
        key_lo=jnp.asarray(key_lo),
        key_mids=tuple(jnp.asarray(km) for km in key_mids),
        pos=jnp.asarray(pos),
        has_neighbors=jnp.asarray(nb),
        n_real=jnp.asarray(n_real),
        genome=jnp.asarray(index.genome.codes),
        genome_packed=jnp.asarray(packed),
        genome_nbits=jnp.asarray(nbits),
        contig_starts=jnp.asarray(np.array([c.offset for c in contigs], np.int32)),
        contig_ends=jnp.asarray(np.array([c.end for c in contigs], np.int32)),
    )


def place_sharded(mesh: Mesh, sharded: ShardedIndexArrays) -> ShardedIndexArrays:
    """Lay the index planes out on the mesh: shard dim over the `shard`
    axis, genome/contig metadata replicated."""
    shard_spec = NamedSharding(mesh, P("shard"))
    repl = NamedSharding(mesh, P())
    return ShardedIndexArrays(
        key_hi=jax.device_put(sharded.key_hi, shard_spec),
        key_lo=jax.device_put(sharded.key_lo, shard_spec),
        key_mids=tuple(jax.device_put(km, shard_spec)
                       for km in sharded.key_mids),
        pos=jax.device_put(sharded.pos, shard_spec),
        has_neighbors=jax.device_put(sharded.has_neighbors, shard_spec),
        bucket_starts=jax.device_put(sharded.bucket_starts, shard_spec),
        n_real=jax.device_put(sharded.n_real, shard_spec),
        genome=jax.device_put(sharded.genome, repl),
        genome_packed=jax.device_put(sharded.genome_packed, repl),
        genome_nbits=jax.device_put(sharded.genome_nbits, repl),
        contig_starts=jax.device_put(sharded.contig_starts, repl),
        contig_ends=jax.device_put(sharded.contig_ends, repl),
    )


class GenomeShards(NamedTuple):
    """Position-sharded packed genome planes [S, ...] for the
    genome-sharded SPMD mode: every device holds G/S + halo bases of the
    2-bit and N-bit planes instead of the whole genome (the >HBM WGS
    regime SURVEY §5.8 targets: 'index shards resident in HBM across a
    pod slice').  Candidates stay replicated after the hit all-gather;
    each shard scores the candidates whose (clipped) start it OWNS and
    the score grids are psum-combined — no all-to-all of reads needed."""

    gp: jax.Array        # uint32 [S, Wl]  local 2-bit slices (+ sentinel pads)
    gn: jax.Array        # uint32 [S, Wnl] local N-bit slices
    base: jax.Array      # int32 [S, 1] owned-range start (multiple of 32)
    end: jax.Array       # int32 [S, 1] owned-range end (start + chunk)


GS_HALO = 8_448   # default halo (bases): max_rescue_window + read + slack


def shard_genome_planes(index: SeedIndex, num_shards: int,
                        halo: int = GS_HALO) -> GenomeShards:
    """Slice the packed genome planes into `num_shards` position ranges.

    Each shard's slice covers [base_s - GENOME_PAD, base_s + chunk +
    halo + GENOME_PAD): the sentinel padding keeps edge-overhang gathers
    valid and the halo covers every window that STARTS in the owned
    range (ungapped scoring windows, semialigned re-scans, and the
    shadow-rescue span — window + mate length must stay <= halo).
    """
    from ..align.pipeline import GN_PAD_WORDS, GP_PAD_WORDS

    g = index.genome.total_length
    cached = getattr(index, "_packed_planes", None)
    packed, nbits = cached if cached is not None else pack_genome(
        index.genome.codes)
    chunk = -(-(-(-g // num_shards)) // 32) * 32
    halo = -(-halo // 32) * 32
    span = chunk + halo
    wl = span // 16 + 2 * GP_PAD_WORDS
    wnl = span // 32 + 2 * GN_PAD_WORDS
    gp = np.zeros((num_shards, wl), np.uint32)
    gn = np.full((num_shards, wnl), 0xFFFFFFFF, np.uint32)   # out-of-range = N
    base = np.zeros((num_shards, 1), np.int32)
    end = np.zeros((num_shards, 1), np.int32)
    for s in range(num_shards):
        b = s * chunk
        base[s, 0] = b
        end[s, 0] = b + chunk
        # local word 0 == global padded word b//16 (the global array
        # already carries GP_PAD_WORDS of sentinel at each end)
        src = packed[b // 16 : b // 16 + wl]
        gp[s, : len(src)] = src
        nsrc = nbits[b // 32 : b // 32 + wnl]
        gn[s, : len(nsrc)] = nsrc
    return GenomeShards(gp=jnp.asarray(gp), gn=jnp.asarray(gn),
                        base=jnp.asarray(base), end=jnp.asarray(end))


def place_genome_shards(mesh: Mesh, gs: GenomeShards) -> GenomeShards:
    spec = NamedSharding(mesh, P("shard"))
    return GenomeShards(*(jax.device_put(v, spec) for v in gs))


def _gs_local(local: IndexArrays, gs_gp, gs_gn, gs_base) -> IndexArrays:
    """The per-shard IndexArrays whose packed planes are the local genome
    slice (plane_base set so every gather indexes locally)."""
    return local._replace(genome_packed=gs_gp[0], genome_nbits=gs_gn[0],
                          plane_base=gs_base[0, 0])


def _gs_hooks(local_gs: IndexArrays, own_lo, own_hi, g_total: int):
    """(score_fn, clip_fn, rescue_fn) for the genome-sharded mode: each
    shard computes only rows/candidates whose position it owns (owner =
    range of the position clipped into [0, G)) against its local planes;
    results combine with psum over the `shard` axis — every position is
    owned by exactly one shard, so masked sums reproduce the
    whole-genome values exactly."""
    from ..align.pairs import mate_window_dynamic, rescue_shadows
    from ..align.pipeline import _score_ungapped, semialigned_clip_device

    def owns(pos):
        pc = jnp.clip(pos, 0, g_total - 1)
        return (pc >= own_lo) & (pc < own_hi)

    def psum(v):
        return jax.lax.psum(v, "shard")

    def score_fn(_arrays, cfg, bases, quals, cs, co, cv):
        own = owns(cs)
        lp, mm, ed, dropped = _score_ungapped(
            local_gs, cfg, bases, quals, cs, co, cv & own)
        lp_sum = psum(jnp.where(jnp.isfinite(lp), lp, 0.0))
        mm_sum = psum(mm)
        ed_sum = psum(ed)
        dropped_any = psum(dropped.astype(jnp.int32)) > 0
        lp_full = jnp.where(cv, lp_sum, jnp.float32(-jnp.inf))
        return lp_full, mm_sum, ed_sum, dropped_any

    def clip_fn(_arrays, cfg, bases, start, rev, aligned, trims):
        own = owns(jnp.where(aligned, start, 0))
        sa = semialigned_clip_device(local_gs, cfg, bases, start, rev,
                                     aligned & own, trims)
        out = {}
        for k, v in sa.items():
            if v.dtype == jnp.bool_:
                out[k] = psum(jnp.where(own, v, False).astype(jnp.int32)) > 0
            else:
                out[k] = psum(jnp.where(own, v, jnp.zeros_like(v)))
        return out

    def rescue_fn(_arrays, cfg, tls, orphan_idx, read_lengths, o_start,
                  o_rev, sb, sq, window):
        # owner of the window START (halo covers the whole span)
        mn_off, _, _ = mate_window_dynamic(tls, orphan_idx, read_lengths,
                                           o_rev)
        win_start = o_start + mn_off
        own = owns(win_start)
        out = rescue_shadows(local_gs, cfg, tls, orphan_idx, read_lengths,
                             o_start, o_rev, sb, sq, window)
        comb = {}
        for k, v in out.items():
            if v.dtype == jnp.bool_:
                comb[k] = psum(jnp.where(own, v, False).astype(jnp.int32)) > 0
            else:
                comb[k] = psum(jnp.where(own, v, jnp.zeros_like(v)))
        return comb

    return score_fn, clip_fn, rescue_fn


def _gathered_find(local: IndexArrays):
    """find_fn for the SPMD path: per-shard seed search + ICI all-gather.

    Because shard_index splits at k-mer boundaries, every k-mer's hit run
    lives in exactly ONE shard — the gathered lists hold exactly the
    single-index hits (plus padding) and the psummed diag counts are
    exact, so align_batch/score_end produce device-count-invariant
    results through this hook."""

    def find_fn(_arrays, cfg, bases):
        s, o, v, c, diag = find_seed_hits(local, cfg, bases)
        ag = lambda x: jax.lax.all_gather(x, "shard", axis=1, tiled=True)
        d = dict(diag)
        d["seed_match_counts"] = jax.lax.psum(d["seed_match_counts"], "shard")
        d["seed_too_many"] = jax.lax.psum(
            d["seed_too_many"].astype(jnp.int32), "shard") > 0
        if "neighbor_hits" in d:
            d["neighbor_hits"] = jax.lax.psum(d["neighbor_hits"], "shard")
        return ag(s), ag(o), ag(v), ag(c), d

    return find_fn


# in_specs for the ShardedIndexArrays field order used by every entry point
# (the first spec covers the key-plane TUPLE (hi, mids..., lo) — a
# PartitionSpec applies as a pytree prefix to every element)
_PLANE_SPECS = (P("shard", None), P("shard", None), P("shard", None),
                P("shard", None), P("shard", None),
                P(), P(), P(), P(), P())


def _plane_args(sharded: ShardedIndexArrays):
    return ((sharded.key_hi, *sharded.key_mids, sharded.key_lo),
            sharded.pos,
            sharded.has_neighbors, sharded.bucket_starts, sharded.n_real,
            sharded.genome, sharded.genome_packed, sharded.genome_nbits,
            sharded.contig_starts, sharded.contig_ends)


def _split_scalars(res: dict):
    """(batch arrays, data-psummed scalars) — scalar stats (seed tallies)
    leave shard_map replicated (out_spec P()) while [B,...] arrays stay
    sharded over `data`."""
    batch = {k: v for k, v in res.items() if v.ndim > 0}
    scalars = {k: jax.lax.psum(v, "data")
               for k, v in res.items() if v.ndim == 0}
    return batch, scalars


def sharded_align(mesh: Mesh, sharded: ShardedIndexArrays, bases, quals,
                  cfg: AlignConfig):
    """Jittable SPMD single-end alignment over the mesh — the exact
    align_batch program (two-pass escalation, device quality trim,
    semialigned clip) with per-shard seed search.

    bases/quals: [B, L] with B divisible by the `data` axis size.
    Returns the same result dict as align_batch, sharded over `data`.
    """

    def local_fn(keys, pos, nb, buckets, n_real, genome, gpack,
                 gnbits, cstarts, cends, b, q):
        local = _local_index(keys, pos, nb, buckets, n_real,
                             genome, gpack, gnbits, cstarts, cends)
        res = align_batch(local, b, q, cfg, find_fn=_gathered_find(local))
        return _split_scalars(res)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=_PLANE_SPECS + (P("data", None), P("data", None)),
        out_specs=(P("data"), P()),
        check_vma=False,
    )
    batch_out, scalars = fn(*_plane_args(sharded), bases, quals)
    return {**batch_out, **scalars}


def _check_gs(cfg: AlignConfig, genome_shards) -> None:
    if genome_shards is None:
        return
    assert cfg.genome_len > 0, \
        "genome-sharded mode needs cfg.genome_len (Aligner.create sets it)"
    # a TRUE 64-mer LongKmerType index needs no extension verify, so it
    # position-shards like any other; only the fallback mode (64-mer
    # seeds over a 32-mer index) gathers genome bases at index-shard
    # positions and stays excluded
    idx_k = cfg.index_seed_len or min(cfg.seed_len, 32)
    assert cfg.seed_len <= idx_k, \
        "genome-sharded mode excludes extension-verified long seeds " \
        "(64-mer seeds over a 32-mer index gather at index-shard " \
        "positions, which are not position-local); build a true 64-mer " \
        "index (build_index(seed_len=64)) instead"


def sharded_align_full(mesh: Mesh, sharded: ShardedIndexArrays, bases, quals,
                       cfg: AlignConfig, tail_masked, lengths,
                       genome_shards: GenomeShards | None = None):
    """The production SPMD single-end program: adapter re-mask from
    counts, the full align_batch (quality trim + semialigned clip on
    device), and output-oriented SEQ/QUAL — the shard_map twin of
    aligner._single_packed_jit, consumed by ShardedAligner.

    With `genome_shards`, the packed genome planes are position-sharded
    over the `shard` axis (G/S + halo per device instead of G): scoring,
    semialigned clipping and rescue run owner-masked per shard and
    psum-combine — same results, a fraction of the HBM."""
    _check_gs(cfg, genome_shards)

    def local_fn(keys, pos, nb, buckets, n_real, genome, gpack,
                 gnbits, cstarts, cends, b, q, tm, ln, *gs):
        local = _local_index(keys, pos, nb, buckets, n_real,
                             genome, gpack, gnbits, cstarts, cends)
        score_fn = clip_fn = None
        if gs:
            gs_gp, gs_gn, gs_base, gs_end = gs
            local_gs = _gs_local(local, gs_gp, gs_gn, gs_base)
            score_fn, clip_fn, _resc = _gs_hooks(
                local_gs, gs_base[0, 0], gs_end[0, 0], cfg.genome_len)
        mb, mq = mask_tail_device(b, q, tm)
        res = align_batch(local, mb, mq, cfg, tm,
                          find_fn=_gathered_find(local),
                          score_fn=score_fn, clip_fn=clip_fn)
        # output orientation happens host-side (the host holds the reads;
        # fetching seq/qual back over the link was the e2e wall)
        return _split_scalars(res)

    gs_args = tuple(genome_shards) if genome_shards is not None else ()
    gs_specs = (P("shard", None),) * len(gs_args)
    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=_PLANE_SPECS + (P("data", None), P("data", None),
                                 P("data"), P("data")) + gs_specs,
        out_specs=(P("data"), P()),
        check_vma=False,
    )
    batch_out, scalars = fn(*_plane_args(sharded), bases, quals,
                            tail_masked, lengths, *gs_args)
    return {**batch_out, **scalars}


# ---------------------------------------------------------------------------
# Paired-end SPMD path (+ in-program shadow rescue)
# ---------------------------------------------------------------------------

def _local_index(keys, pos, nb, buckets, n_real, genome, gpack,
                 gnbits, cstarts, cends) -> IndexArrays:
    """Unwrap the per-shard blocks shard_map hands the local function.
    `keys` is the (hi, mids..., lo) plane tuple."""
    return IndexArrays(
        key_hi=keys[0][0], key_lo=keys[-1][0],
        key_mids=tuple(k[0] for k in keys[1:-1]), pos=pos[0],
        has_neighbors=nb[0], bucket_starts=buckets[0],
        n_real=n_real[0, 0], genome=genome,
        genome_packed=gpack, genome_nbits=gnbits,
        contig_starts=cstarts, contig_ends=cends)


def _rescue_inline(local: IndexArrays, cfg: AlignConfig, tls, res,
                   b1, q1, b2, q2, window: int, rescue_fn=None,
                   rescue_tls=None):
    """Vectorized in-program shadow rescue + merge (the SPMD analog of
    PairedAligner._apply_rescue/_merge_rescue).

    COMPACTED (round 5; the round-3/4 full-row scan's cost model was
    wrong on hardware — measured +0.8 s/batch): only rows that NEED a
    rescue (shadow or disjoined, typically <5%) gather into a
    fixed-capacity block before the window scan; results scatter back.
    Rows beyond the n//8 capacity are counted in `rescue_dropped`
    (never wrong results — a missed optional rescue, only in
    pathological all-shadow batches).  `window` is the shape-setting
    static scan width (host-quantized); `tls` fields are traced, so
    learned-model changes never recompile."""
    from ..align.pairs import pair_length, pair_model, rescue_shadows
    l1, l2 = b1.shape[1], b2.shape[1]
    n = res["aligned_1"].shape[0]
    for shadow_end in (1, 2):
        res[f"rescued_{shadow_end}"] = jnp.zeros(n, bool)
    disjoined_pre = res.get("disjoined", jnp.zeros(n, bool))
    kcap = min(max(n // 8, 64), n)

    # both directions computed up-front from the ORIGINAL placements:
    # outs[shadow_end] rescues that end anchored at the other end's pick
    outs = {}
    dropped = jnp.int32(0)
    for shadow_end, orphan_end in ((1, 2), (2, 1)):
        sb, sq = (b1, q1) if shadow_end == 1 else (b2, q2)
        need = res[f"shadow_{shadow_end}"] | disjoined_pre
        (rows,) = jnp.nonzero(need, size=kcap, fill_value=n)
        ok = rows < n
        safe = jnp.minimum(rows, n - 1)
        dropped = dropped + jnp.maximum(
            jnp.sum(need.astype(jnp.int32)) - kcap, 0)
        o_start = res[f"start_{orphan_end}"][safe].astype(jnp.int32)
        o_rev = res[f"reverse_{orphan_end}"][safe]
        out_c = (rescue_fn or rescue_shadows)(
            local, cfg, rescue_tls if rescue_tls is not None else tls,
            orphan_end - 1, (l1, l2), o_start, o_rev, sb[safe], sq[safe],
            window)
        # scatter back to [n] planes; invalid rows land in a pad slot
        dest = jnp.where(ok, rows, n)
        out = {}
        for k, v in out_c.items():
            full = jnp.zeros((n + 1,) + v.shape[1:], v.dtype)
            out[k] = full.at[dest].set(v)[:n]
        outs[shadow_end] = out
    res["rescue_dropped"] = res.get("rescue_dropped", jnp.int32(0)) + dropped

    # disjoined-template direction choice (buildDisjoinedTemplate,
    # TemplateBuilder.cpp:716-866): best (summed mismatch score, then
    # summed log probability) wins; orphan 1 wins ties (scan order)
    disjoined = res.get("disjoined", jnp.zeros(n, bool))
    keys = {}
    for orphan_end in (1, 2):
        o = outs[3 - orphan_end]
        key = (res[f"mismatches_{orphan_end}"].astype(jnp.float32)
               + o["mismatches"].astype(jnp.float32)) * jnp.float32(1e5) \
            - (res[f"log_prob_{orphan_end}"] + o["log_prob"])
        keys[orphan_end] = jnp.where(o["found"], key, jnp.float32(jnp.inf))
    use2 = keys[2] < keys[1]

    for shadow_end, orphan_end in ((1, 2), (2, 1)):
        out = outs[shadow_end]
        se = f"_{shadow_end}"
        dir_sel = use2 if orphan_end == 2 else ~use2
        hit = out["found"] & (res["shadow" + se]
                              | (disjoined & dir_sel))
        res["rescued" + se] = hit
        res["aligned" + se] = res["aligned" + se] | hit
        for key, val in (("start", out["start"]),
                         ("reverse", out["reverse"]),
                         ("mismatches", out["mismatches"]),
                         ("edit_distance", out["edit_distance"]),
                         ("log_prob", out["log_prob"])):
            res[key + se] = jnp.where(hit, val.astype(res[key + se].dtype),
                                      res[key + se])
        res["shadow" + se] = res["shadow" + se] & ~hit
        # rescued-pair score: computed in-kernel in log space
        # (pairs.rescue_shadows), shared with the host rescue pass
        score = out["score"].astype(jnp.int32)
        res["frag_score" + se] = jnp.where(hit, score, res["frag_score" + se])
        res["template_score"] = jnp.where(hit, score, res["template_score"])
        p1, p2 = res["start_1"], res["start_2"]
        r1, r2 = res["reverse_1"], res["reverse_2"]
        model = pair_model(p1, r1, p2, r2)
        length = pair_length(p1, l1, p2, l2)
        nominal = ((model == tls.best0) | (model == tls.best1)) & \
            (length >= tls.min) & (length <= tls.max)
        res["pair_resolved"] = res["pair_resolved"] | hit
        res["proper_pair"] = jnp.where(hit, nominal, res["proper_pair"])
        res["template_length"] = jnp.where(
            hit, length.astype(res["template_length"].dtype),
            res["template_length"])
    if "disjoined" in res:
        res["disjoined"] = disjoined & ~res["rescued_1"] & ~res["rescued_2"]
    return res


def sharded_align_paired(mesh: Mesh, sharded: ShardedIndexArrays,
                         b1, q1, b2, q2, cfg: AlignConfig, tls,
                         rescue: bool = True, window: int | None = None):
    """Jittable SPMD paired-end alignment over the (data, shard) mesh:
    the exact align_paired_batch program (two-pass escalation, device
    quality trim, semialigned clip, pair resolution) with per-shard seed
    search, plus in-program shadow rescue.

    `tls` rides through shard_map as a replicated TRACED pytree (no
    recompile on model change); `window` is the static rescue-scan width
    — when omitted it is derived from concrete tls fields (callers inside
    jit with a traced tls must pass it explicitly)."""
    from ..align.pairs import align_paired_batch, quantize_rescue_window

    if rescue and window is None:
        window = quantize_rescue_window(
            int(tls.mate_max) - int(tls.mate_min) + 1, 1 << 30)

    def local_fn(keys, pos, nb, buckets, n_real, genome, gpack,
                 gnbits, cstarts, cends, tls, b1, q1, b2, q2):
        local = _local_index(keys, pos, nb, buckets, n_real,
                             genome, gpack, gnbits, cstarts, cends)
        res = align_paired_batch(local, b1, q1, b2, q2, cfg, tls,
                                 find_fn=_gathered_find(local))
        if rescue:
            mb1, mq1 = mask_tail_device(b1, q1, res["qtrim_1"])
            mb2, mq2 = mask_tail_device(b2, q2, res["qtrim_2"])
            res = _rescue_inline(local, cfg, tls, res, mb1, mq1, mb2, mq2,
                                 window)
        return _split_scalars(res)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=_PLANE_SPECS + (P(),) + (P("data", None),) * 4,
        out_specs=(P("data"), P()),
        check_vma=False,
    )
    batch_out, scalars = fn(*_plane_args(sharded), tls, b1, q1, b2, q2)
    return {**batch_out, **scalars}


def sharded_align_paired_full(mesh: Mesh, sharded: ShardedIndexArrays,
                              b1, q1, b2, q2, cfg: AlignConfig, tls,
                              tm1, tm2, len1, len2, rescue: bool = True,
                              genome_shards: GenomeShards | None = None,
                              window: int | None = None, rescue_tls=None):
    """The production SPMD paired program: adapter re-mask from counts,
    the full align_paired_batch, in-program shadow rescue on the fully
    masked reads, a post-rescue semialigned re-clip of rescued rows, and
    per-end output-oriented SEQ/QUAL — the shard_map twin of
    aligner._paired_packed_jit (+ the host rescue pass), consumed by
    ShardedPairedAligner.  `genome_shards` position-shards the packed
    genome planes (see sharded_align_full).  `tls` is a traced replicated
    pytree; `window` is the static rescue width (derived from concrete
    tls fields when omitted)."""
    from ..align.pairs import align_paired_batch, quantize_rescue_window
    from ..align.pipeline import semialigned_clip_device
    _check_gs(cfg, genome_shards)

    if rescue and window is None:
        window = quantize_rescue_window(
            int(tls.mate_max) - int(tls.mate_min) + 1, 1 << 30)

    def local_fn(keys, pos, nb, buckets, n_real, genome, gpack,
                 gnbits, cstarts, cends, tls, rtls, b1, q1, b2, q2, tm1,
                 tm2, l1v, l2v, *gs):
        local = _local_index(keys, pos, nb, buckets, n_real,
                             genome, gpack, gnbits, cstarts, cends)
        score_fn = clip_fn = rescue_fn = None
        clip_dev = semialigned_clip_device
        if gs:
            gs_gp, gs_gn, gs_base, gs_end = gs
            local_gs = _gs_local(local, gs_gp, gs_gn, gs_base)
            score_fn, clip_fn, rescue_fn = _gs_hooks(
                local_gs, gs_base[0, 0], gs_end[0, 0], cfg.genome_len)
            clip_dev = clip_fn
        mb1, mq1 = mask_tail_device(b1, q1, tm1)
        mb2, mq2 = mask_tail_device(b2, q2, tm2)
        res = align_paired_batch(local, mb1, mq1, mb2, mq2, cfg, tls,
                                 tm1, tm2, find_fn=_gathered_find(local),
                                 score_fn=score_fn, clip_fn=clip_fn)
        if rescue:
            # rescue scans with fully masked reads (adapter + qual trim),
            # like the host pass (aligner.PairedAligner._apply_rescue runs
            # after apply_quality_trim_masks)
            rb1, rq1 = mask_tail_device(b1, q1, tm1 + res["qtrim_1"])
            rb2, rq2 = mask_tail_device(b2, q2, tm2 + res["qtrim_2"])
            res = _rescue_inline(local, cfg, tls, res, rb1, rq1, rb2, rq2,
                                 window, rescue_fn=rescue_fn,
                                 rescue_tls=rtls)
            if cfg.semialigned_clip:
                # rescued rows were unaligned when the in-batch clip ran:
                # re-clip them at their rescued placement (host analog:
                # clippers.clip_semialigned(row_mask=rescued))
                for sfx, (bb, qq, tm) in (("_1", (b1, q1, tm1)),
                                          ("_2", (b2, q2, tm2))):
                    mb, mq = mask_tail_device(bb, qq, tm + res["qtrim" + sfx])
                    sa = clip_dev(
                        local, cfg, mb, res["start" + sfx],
                        res["reverse" + sfx], res["aligned" + sfx],
                        tm + res["qtrim" + sfx])
                    hit = res["rescued" + sfx]
                    for k, v in sa.items():
                        res[k + sfx] = jnp.where(hit, v, res[k + sfx])
        # output orientation happens host-side (see sharded_align_full)
        return _split_scalars(res)

    gs_args = tuple(genome_shards) if genome_shards is not None else ()
    gs_specs = (P("shard", None),) * len(gs_args)
    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=_PLANE_SPECS + (P(), P()) + (P("data", None),) * 4
        + (P("data"),) * 4 + gs_specs,
        out_specs=(P("data"), P()),
        check_vma=False,
    )
    batch_out, scalars = fn(*_plane_args(sharded), tls,
                            rescue_tls if rescue_tls is not None else tls,
                            b1, q1, b2, q2, tm1, tm2, len1, len2, *gs_args)
    return {**batch_out, **scalars}


# ---------------------------------------------------------------------------
# Collective duplicate marking (position-sharded shuffle + on-device sort)
# ---------------------------------------------------------------------------

def collective_dedup(mesh: Mesh, axis: str, anchor_self, anchor_mate,
                     rank, tie, cls, lib, capacity_factor: float = 4.0):
    """Jittable collective duplicate marking over one mesh axis.

    The SPMD analog of the Build phase's per-bin dedup (SURVEY §5.8
    "collective shuffle onto position-sharded owners + on-device sort"):
    every record routes to the device owning its anchor (all_to_all over
    ICI), owners sort received records by the duplicate key
    (cls, lib, anchor_self, anchor_mate) with rank/tie descending, mark
    every non-first key member, and the flags ride the inverse all_to_all
    home.

    64-bit columns (anchors/rank/tie) travel as hi/lo int32 plane pairs
    so the kernel works without jax x64 mode.  Inputs MUST be host numpy
    int64 arrays ([N], N divisible by the axis size) — a jnp array would
    already have been truncated to int32 under the default x64=off
    config, silently corrupting the keys.  Returns
    (dup flags [N] bool, overflow [devices] int32) — overflow counts rows
    that exceeded a destination's receive capacity (kept as
    non-duplicates, reported, never silently wrong-marked).
    """
    n_dev = mesh.shape[axis]

    def split64(v):
        """int64 -> (hi, lo) int32 planes whose SIGNED lexicographic
        order equals the int64 order (lo is bias-flipped so bit 31
        doesn't wrap the comparison)."""
        v = np.asarray(v, np.int64)
        hi = (v >> 32).astype(np.int32)
        lo = ((v & 0xFFFFFFFF) - 0x80000000).astype(np.int32)
        return hi, lo

    s_hi, s_lo = split64(anchor_self)
    m_hi, m_lo = split64(anchor_mate)
    r_hi, r_lo = split64(rank)
    t_hi, t_lo = split64(tie)
    cls32 = np.asarray(cls, np.int32)
    lib32 = np.asarray(lib, np.int32)

    def local_fn(s_hi, s_lo, m_hi, m_lo, r_hi, r_lo, t_hi, t_lo, cls_, lib_):
        n_loc = s_hi.shape[0]
        # floor the per-destination capacity so tiny, duplicate-heavy
        # bins (everything routing to one owner) can't overflow
        cap = max(int(np.ceil(capacity_factor * n_loc / n_dev)),
                  min(n_loc, 64))
        consider = cls_ >= 0
        # owner by a multiplicative hash of the anchor (raw `% n_dev`
        # routes even-only positional anchors to half the devices);
        # skipped rows route nowhere
        h = (s_lo * jnp.int32(-1640531527)) ^ s_hi
        owner = jnp.where(consider, (h & 0x7FFFFFFF) % n_dev, n_dev)

        # slot rows into the [n_dev, cap] send buffer
        order = jnp.argsort(owner, stable=True)
        owner_s = owner[order]
        idx = jnp.arange(n_loc, dtype=jnp.int32)
        run_start = jnp.searchsorted(owner_s, owner_s, side="left")
        within = idx - run_start
        ok = (owner_s < n_dev) & (within < cap)
        slot = jnp.where(ok, owner_s * cap + within, n_dev * cap)
        overflow = jnp.sum((owner_s < n_dev) & (within >= cap))

        def send(v, fill):
            buf = jnp.full(n_dev * cap + 1, fill, jnp.int32)
            buf = buf.at[slot].set(v[order].astype(jnp.int32), mode="drop")
            return buf[:-1].reshape(n_dev, cap)

        cols = [s_hi, s_lo, m_hi, m_lo, r_hi, r_lo, t_hi, t_lo, cls_, lib_,
                idx]
        fills = [0, 0, 0, 0, -1, -1, -1, -1, -1, -1, -1]
        payload = jnp.stack([send(v, f) for v, f in zip(cols, fills)],
                            axis=-1)                   # [n_dev, cap, 11]
        recv = jax.lax.all_to_all(payload, axis, split_axis=0,
                                  concat_axis=0, tiled=True)
        r = recv.reshape(n_dev * cap, 11)
        (rs_hi, rs_lo, rm_hi, rm_lo, rr_hi, rr_lo, rt_hi, rt_lo, rc, rl,
         rsrc) = (r[:, i] for i in range(11))
        valid = (rc >= 0).astype(jnp.int32)

        # sort by dup key; rank/tie descending via bitwise-not of the
        # (unsigned-ordered) hi/lo planes
        flip = lambda x: ~x
        pos0 = jnp.arange(n_dev * cap, dtype=jnp.int32)
        sorted_cols = jax.lax.sort(
            (1 - valid, rc, rl, rs_hi, rs_lo, rm_hi, rm_lo,
             flip(rr_hi), flip(rr_lo), flip(rt_hi), flip(rt_lo), pos0),
            num_keys=11)
        inv_s, c2, l2_, sh2, sl2, mh2, ml2 = sorted_cols[:7]
        pos2 = sorted_cols[-1]
        same = jnp.concatenate([
            jnp.zeros(1, bool),
            (c2[1:] == c2[:-1]) & (l2_[1:] == l2_[:-1])
            & (sh2[1:] == sh2[:-1]) & (sl2[1:] == sl2[:-1])
            & (mh2[1:] == mh2[:-1]) & (ml2[1:] == ml2[:-1])
            & (inv_s[1:] == 0) & (inv_s[:-1] == 0)])
        dup = jnp.zeros(n_dev * cap, jnp.int32).at[pos2].set(
            same.astype(jnp.int32))

        # route flags home: same [n_dev, cap] layout back + scatter by src
        back = jax.lax.all_to_all(
            jnp.stack([dup.reshape(n_dev, cap),
                       rsrc.reshape(n_dev, cap)], axis=-1),
            axis, split_axis=0, concat_axis=0, tiled=True)
        b2 = back.reshape(n_dev * cap, 2)
        flags = jnp.zeros(n_loc + 1, jnp.int32).at[
            jnp.where(b2[:, 1] >= 0, b2[:, 1], n_loc)].max(
            b2[:, 0], mode="drop")
        return flags[:-1].astype(bool), overflow[None].astype(jnp.int32)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=tuple([P(axis)] * 10),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    return fn(s_hi, s_lo, m_hi, m_lo, r_hi, r_lo, t_hi, t_lo, cls32, lib32)
