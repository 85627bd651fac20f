"""Device neighbor annotation: the permute->sort->scan pigeonhole pass on
the accelerator.

Reference analog: NeighborsFinder (lib/reference/NeighborsFinder.cpp:
193-384) + oligo::Permutate (lib/oligo/Permutate.cpp:125-175) — the same
C(2E, E) block design as index/neighbors.py, recomposed for the device:

- the UNIQUE k-mers upload ONCE as int32 word planes and stay resident
  while the host loops over the 70 block permutations;
- per permutation: block extraction/repack is vectorized shift/mask
  math, the sort is `jax.lax.sort` over biased int32 word keys, and the
  equal-prefix neighbor scan is a WINDOWED pass (compare row i with rows
  i+1..i+W via shifted slices) instead of run extraction — for any run
  of length <= W this examines exactly the pairs the reference's
  markNeighbors scan does, and for longer runs it examines a superset of
  the host path's run-capped pairs (strictly more sensitive; the
  run_cap=256 loss-free proof in scripts/neighbor_scale_proof.py bounds
  how little that matters);
- 2-bit-base Hamming via XOR + (x|x>>1)&0x5555... + popcount.

Supports 16/32/64-mer keys (the 64-mer case permutes 16-bit blocks
across the four word planes).

The block geometry aligns with word boundaries by construction: 2k bits
over 8 blocks => block widths 4/8/16 bits for k=16/32/64, so a permuted
k-mer repacks into the same int32 word layout and the prefix (first E
blocks) occupies exactly the leading half of the bit string.

Sizes derive from the device's memory (`memory_stats()["bytes_limit"]`;
host RAM for a CPU device): one permutation's single sort holds
SORT_WORD_BYTES per key word plus SORT_FIXED_BYTES per record, and
inputs beyond that run the PARTITIONED program (split by the first prefix
block's value — a prefix of the sort key, so equal-prefix runs never
straddle parts).
"""

from __future__ import annotations

import numpy as np

from ..utils.device import device_bytes
from .neighbors import DEFAULT_WIDTH, block_permutations

#: device bytes per record and key word of one single-sort permutation:
#: resident words, permuted words, sort operands in and out, and the
#: padded prefix/suffix copies of the scan
SORT_WORD_BYTES = 24
#: per-record bytes beside the key words: the index operand (in and
#: out), the running and per-permutation bit vectors, scan temporaries
SORT_FIXED_BYTES = 24


def device_sort_max(n_words: int) -> int:
    """Largest record count one permutation sorts in a single pass."""
    return device_bytes() // (SORT_WORD_BYTES * n_words + SORT_FIXED_BYTES)


def device_max_records(n_words: int) -> int:
    """Largest input the partitioned program holds: the resident words,
    permuted words, part ids and bits in half the memory, one part's
    sort (half the single-sort bound) in the other half."""
    return (device_bytes() // 2) // (8 * n_words + 5)


def _popcount32(x):
    import jax.numpy as jnp
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _base_mm32(x):
    """Count differing 2-bit bases given the XOR of two packed words."""
    import jax.numpy as jnp
    return _popcount32((x | (x >> 1)) & 0x55555555)


def _geometry(k: int) -> tuple[int, int, int]:
    """(n_words, block_bits, blocks_per_word) for 8-block keys."""
    n_words = max(1, (2 * k) // 32)
    block_bits = (2 * k) // 8
    return n_words, block_bits, 8 // n_words if n_words <= 8 else 1


def _partition_tables(planes, k: int, perms: np.ndarray, part_cap: int
                      ) -> tuple[np.ndarray, int]:
    """Host-side balanced partition plan beyond the single-sort bound.

    For each permutation, every k-mer's sort key starts with block
    perms[p][0]; grouping the 2^block_bits possible VALUES of that block
    into parts therefore splits each permutation's sorted order into
    contiguous, run-respecting ranges.  Greedy first-fit packs values
    into parts of <= part_cap records; returns (part_tab [P_perms,
    2^block_bits] int32, n_parts)."""
    n_words, block_bits, bpw = _geometry(k)
    nvals = 1 << block_bits
    # per-block value histograms: counts[j, v] = #kmers with block j == v
    counts = np.zeros((8, nvals), np.int64)
    for j in range(8):
        w = np.asarray(planes[j // bpw], np.uint32)
        sh = np.uint32(32 - block_bits * (j % bpw + 1))
        vals = (w >> sh) & np.uint32(nvals - 1)
        counts[j] = np.bincount(vals, minlength=nvals)
    if counts.max() > part_cap:
        raise ValueError(
            f"degenerate block-value skew: one value holds "
            f"{counts.max()} records > part cap {part_cap}")
    part_tab = np.zeros((perms.shape[0], nvals), np.int32)
    n_parts = 1
    for p, order in enumerate(perms):
        c = counts[order[0]]
        pid = 0
        acc = 0
        for v in range(nvals):
            if acc + c[v] > part_cap and acc > 0:
                pid += 1
                acc = 0
            part_tab[p, v] = pid
            acc += int(c[v])
        n_parts = max(n_parts, pid + 1)
    return part_tab, n_parts


def find_neighbors_device(planes, k: int,
                          error_count: int = DEFAULT_WIDTH,
                          window: int = 256,
                          sort_max: int | None = None) -> np.ndarray:
    """Bool bits for UNIQUE k-mers given their UNBIASED uint32 word
    planes (tuple of [n] arrays, most-significant first).

    Per permutation, one jitted program: permute -> lax.sort -> windowed
    suffix-Hamming scan, OR-ing marks.  Above `sort_max` records
    (default `device_sort_max`) the sort+scan runs per PARTITION of at
    most sort_max // 2 records (first-prefix-block value groups — see
    _partition_tables).
    """
    import jax
    import jax.numpy as jnp

    assert error_count == 4, "block design fixed at 8 blocks (E=4)"
    n_words, block_bits, bpw = _geometry(k)
    assert len(planes) == n_words, (len(planes), n_words)
    n = planes[0].shape[0]
    if n < 2:
        return np.zeros(n, bool)
    perms = np.asarray(block_permutations(error_count), np.int32)  # [70, 8]

    if sort_max is None:
        sort_max = device_sort_max(n_words)
    if n > sort_max:
        return _find_neighbors_device_partitioned(
            planes, k, perms, error_count, window, sort_max // 2)

    words_np = np.stack([np.asarray(p, np.uint32).view(np.int32)
                         for p in planes])           # [n_words, n] int32

    # ONE permutation per jit call, looped from the host with the words
    # and the running bit vector DEVICE-RESIDENT between calls: the
    # per-permutation program compiles far faster than a fused
    # all-permutations one, and 70 dispatches are noise against the sorts
    @jax.jit
    def one_perm(words, order, bits):
        mask = (1 << block_bits) - 1

        def block(j_dyn):
            """Block j (traced index) of every k-mer, [n] int32."""
            w = jax.lax.dynamic_index_in_dim(words, j_dyn // bpw, axis=0,
                                             keepdims=False)
            sh = 32 - block_bits * (j_dyn % bpw + 1)
            return jax.lax.shift_right_logical(w, sh) & jnp.int32(mask)

        # repack permuted blocks straight into words — no persistent
        # [8, n] block stack (1.5 GB at chr21 scale)
        pw = []
        for w in range(n_words):
            acc = jnp.zeros((n,), jnp.int32)
            for s in range(bpw):
                acc = acc | jax.lax.shift_left(
                    block(order[w * bpw + s]),
                    jnp.int32(32 - block_bits * (s + 1)))
            pw.append(acc)
        # sort by words lexicographically (biased for unsigned order)
        bias = jnp.int32(-2**31)
        keys = [w + bias for w in pw] + [jnp.arange(n, dtype=jnp.int32)]
        sorted_ops = jax.lax.sort(tuple(keys), num_keys=n_words)
        sw = [w for w in sorted_ops[:n_words]]
        idx = sorted_ops[-1]

        # prefix = first 4 blocks = leading half of the bit string
        if n_words == 1:
            pref_w = [jax.lax.shift_right_logical(sw[0] - bias,
                                                  jnp.int32(16))]
            suf = [(sw[0] - bias) & jnp.int32(0xFFFF)]
        elif n_words == 2:
            pref_w = [sw[0]]
            suf = [sw[1] - bias]
        else:            # 4 words: prefix = words 0-1, suffix = 2-3
            pref_w = [sw[0], sw[1]]
            suf = [sw[2] - bias, sw[3] - bias]

        # shifted compares via PRE-PADDED dynamic slices: one copy per
        # step and no wraparound, unlike jnp.roll
        sentinel = jnp.int32(-1)
        pref_p = [jnp.concatenate([w, jnp.full((window,), sentinel,
                                               jnp.int32)])
                  for w in pref_w]
        suf_p = [jnp.concatenate([w, jnp.zeros((window,), jnp.int32)])
                 for w in suf]
        rows = jnp.arange(n, dtype=jnp.int32)

        def shifted(xp, d):
            return jax.lax.dynamic_slice(xp, (d,), (n,))

        def scan_d(d, hit):
            valid = rows < (n - d)
            same = valid
            for w, wp in zip(pref_w, pref_p):
                same = same & (w == shifted(wp, d))
            mm = jnp.zeros(n, jnp.int32)
            for w, wp in zip(suf, suf_p):
                mm = mm + _base_mm32(w ^ shifted(wp, d))
            near = same & (mm <= error_count) & (mm > 0)
            # mark the partner row i+d: pad near at the FRONT, slice
            nearp = jnp.concatenate([jnp.zeros((window,), bool), near])
            partner = jax.lax.dynamic_slice(nearp, (window - d,), (n,))
            return hit | near | partner

        hit = jax.lax.fori_loop(1, window + 1, scan_d,
                                jnp.zeros(n, bool))
        return bits.at[idx].max(hit)

    words_dev = jnp.asarray(words_np)
    perms_dev = jnp.asarray(perms)
    bits = jnp.zeros(n, bool)
    for p in range(perms.shape[0]):
        bits = one_perm(words_dev, perms_dev[p], bits)
    return np.asarray(jax.device_get(bits))


def _find_neighbors_device_partitioned(planes, k: int, perms: np.ndarray,
                                       error_count: int,
                                       window: int,
                                       part_cap: int) -> np.ndarray:
    """Partitioned device annotation for inputs beyond the single-sort
    bound: per permutation, rows partition by their first-prefix-block
    value group (part_tab), each part gathers into a part_cap-row block,
    sorts, scans, and scatters its marks — exact, because a partition
    boundary is always a prefix-run boundary."""
    import jax
    import jax.numpy as jnp

    n_words, block_bits, bpw = _geometry(k)
    n = planes[0].shape[0]
    part_tab_np, n_parts = _partition_tables(planes, k, perms, part_cap)

    words_np = np.stack([np.asarray(p, np.uint32).view(np.int32)
                         for p in planes])

    @jax.jit
    def run_perm(words, order, ptab, bits):
        """One permutation (host-looped like the plain path)."""
        mask = (1 << block_bits) - 1

        def block(j_dyn):
            w = jax.lax.dynamic_index_in_dim(words, j_dyn // bpw, axis=0,
                                             keepdims=False)
            sh = 32 - block_bits * (j_dyn % bpw + 1)
            return jax.lax.shift_right_logical(w, sh) & jnp.int32(mask)

        if True:
            pw = []
            for w in range(n_words):
                acc = jnp.zeros((n,), jnp.int32)
                for s in range(bpw):
                    acc = acc | jax.lax.shift_left(
                        block(order[w * bpw + s]),
                        jnp.int32(32 - block_bits * (s + 1)))
                pw.append(acc)
            pid = jnp.take(ptab, block(order[0]))

            bias = jnp.int32(-2**31)
            cap = part_cap

            def one_part(part, bits):
                (rows,) = jnp.nonzero(pid == part, size=cap, fill_value=n)
                ok = rows < n
                safe = jnp.minimum(rows, n - 1)
                # invalid rows carry the max key -> sort to the end
                keys = [jnp.where(ok, jnp.take(w, safe) + bias,
                                  jnp.int32(2**31 - 1)) for w in pw]
                keys.append(jnp.take(jnp.arange(n, dtype=jnp.int32), safe))
                sorted_ops = jax.lax.sort(tuple(keys), num_keys=n_words)
                sw = list(sorted_ops[:n_words])
                idx = sorted_ops[-1]
                m = jnp.sum(ok.astype(jnp.int32))

                if n_words == 1:
                    pref_w = [jax.lax.shift_right_logical(sw[0] - bias,
                                                          jnp.int32(16))]
                    suf = [(sw[0] - bias) & jnp.int32(0xFFFF)]
                elif n_words == 2:
                    pref_w = [sw[0]]
                    suf = [sw[1] - bias]
                else:
                    pref_w = [sw[0], sw[1]]
                    suf = [sw[2] - bias, sw[3] - bias]

                sentinel = jnp.int32(-1)
                pref_p = [jnp.concatenate([w, jnp.full((window,), sentinel,
                                                       jnp.int32)])
                          for w in pref_w]
                suf_p = [jnp.concatenate([w, jnp.zeros((window,),
                                                       jnp.int32)])
                         for w in suf]
                rws = jnp.arange(cap, dtype=jnp.int32)

                def scan_d(d, hit):
                    valid = rws < (m - d)
                    same = valid
                    for w, wp in zip(pref_w, pref_p):
                        same = same & (w == jax.lax.dynamic_slice(
                            wp, (d,), (cap,)))
                    mm = jnp.zeros(cap, jnp.int32)
                    for w, wp in zip(suf, suf_p):
                        mm = mm + _base_mm32(w ^ jax.lax.dynamic_slice(
                            wp, (d,), (cap,)))
                    near = same & (mm <= error_count) & (mm > 0)
                    nearp = jnp.concatenate(
                        [jnp.zeros((window,), bool), near])
                    partner = jax.lax.dynamic_slice(nearp, (window - d,),
                                                    (cap,))
                    return hit | near | partner

                hit = jax.lax.fori_loop(1, window + 1, scan_d,
                                        jnp.zeros(cap, bool))
                in_part = rws < m
                return bits.at[jnp.minimum(idx, n - 1)].max(hit & in_part)

            return jax.lax.fori_loop(0, n_parts, one_part, bits)

    words_dev = jnp.asarray(words_np)
    perms_dev = jnp.asarray(perms)
    ptab_dev = jnp.asarray(part_tab_np)
    bits = jnp.zeros(n, bool)
    for p in range(perms.shape[0]):
        bits = run_perm(words_dev, perms_dev[p], ptab_dev[p], bits)
    return np.asarray(jax.device_get(bits))


def annotate_unique_auto(uniq_planes, k: int,
                         error_count: int = DEFAULT_WIDTH,
                         run_cap: int = 256,
                         prefer_device: bool | None = None) -> np.ndarray:
    """Device-or-host neighbor bits for unique k-mers.

    `uniq_planes`: tuple of unbiased uint32 word arrays (MSB first).
    The device path runs when E=4, the window is bounded and the input
    fits `device_max_records`; the vectorized host path covers the rest.
    A device failure raises: it never falls back to the host.
    """
    n = uniq_planes[0].shape[0]
    use_dev = prefer_device
    if use_dev is None:
        # the windowed device scan costs O(window) fori steps — an
        # "uncapped" run_cap (truncation-proof harnesses pass 2^30)
        # belongs on the host run-scan path
        use_dev = (error_count == DEFAULT_WIDTH and run_cap <= 4096
                   and n <= device_max_records(len(uniq_planes)))
    if use_dev:
        return find_neighbors_device(uniq_planes, k,
                                     error_count=error_count,
                                     window=run_cap)
    from .neighbors import find_neighbors
    if k <= 32:
        hi = uniq_planes[0].astype(np.uint64)
        if k == 32:
            km = (hi << np.uint64(32)) | uniq_planes[1].astype(np.uint64)
        else:
            km = hi
        return find_neighbors(km, k=k, error_count=error_count,
                              run_cap=run_cap)
    raise NotImplementedError(
        "64-mer host neighbor annotation: use the device path")
