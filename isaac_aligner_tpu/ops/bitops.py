"""On-device 2-bit sequence ops: seed packing, reverse complement.

Reference analog: oligo/KmerGenerator.hpp + the per-cycle seed construction
in SeedLoader (src/c++/lib/alignment/SeedLoader.cpp:160-231).  The device
design packs whole read batches at once with unrolled shift-or folds over
static seed offsets — pure element-wise work that XLA fuses into one
pass over the read tensor.

Keys are bias-encoded into int32 (xor 0x80000000) so SIGNED comparison
reproduces unsigned 2-bit lexicographic order; the index stores the same
encoding (index/build.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna

# numpy scalar: importing must not touch a JAX backend
_BIAS = np.uint32(1 << 31)


def bias_keys(u32: jax.Array) -> jax.Array:
    """uint32 -> order-preserving int32."""
    return jax.lax.bitcast_convert_type(u32 ^ _BIAS, jnp.int32)


def revcomp_reads(bases: jax.Array) -> jax.Array:
    """[B, L] uint8 codes -> reverse-complement codes (N stays N)."""
    comp = jnp.where(bases < dna.NUM_BASES, 3 - bases, bases)
    return comp[:, ::-1]


def reverse_quals(quals: jax.Array) -> jax.Array:
    return quals[:, ::-1]


def pack_seed(bases: jax.Array, offset: int, seed_len: int):
    """Pack one seed per read from [B, L] code array at a static offset.

    Returns (key_hi, key_lo) as biased int32 [B] and `has_n` bool [B].
    For seed_len 16 the low word is 0 (matching index build).
    """
    if seed_len not in (16, 32):
        raise ValueError("seed_len must be 16 or 32")
    window = bases[:, offset : offset + seed_len].astype(jnp.uint32)
    has_n = jnp.any(window >= dna.NUM_BASES, axis=1)
    w = jnp.where(window >= dna.NUM_BASES, 0, window)  # keep packing well-defined
    hi = jnp.zeros(bases.shape[0], dtype=jnp.uint32)
    for j in range(16):
        hi = (hi << jnp.uint32(2)) | w[:, j]
    if seed_len == 32:
        lo = jnp.zeros(bases.shape[0], dtype=jnp.uint32)
        for j in range(16, 32):
            lo = (lo << jnp.uint32(2)) | w[:, j]
    else:
        lo = jnp.zeros_like(hi)
    return bias_keys(hi), bias_keys(lo), has_n
