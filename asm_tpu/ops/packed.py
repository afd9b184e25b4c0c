"""Bit-packed lane rows: uint32 words + popcount/ctz queries.

This is the batched rendition of the reference's `int_128bit`/`int_256bit`
registers (GASMA/utils.h:49-549): a lane row of L positions is W = L/32
uint32 words, bit p of word w = position 32*w + p (LSB-first, exactly the
reference's little-endian bit order). Every register query maps to a short
vector computation over the [.., W] word axis:

  first_one / first_zero  (tzcnt scan, utils.h:168-191)
     -> per-word ctz via popcount((w & -w) - 1), min over words
  pop_count_between       (shift-truncate + POPCNT, utils.h:263-270)
     -> range masks from word-index arithmetic + lax.population_count

Compared to the unpacked bool[..., L] rows this is 32x less data per query
— the difference between the greedy/LEAP inner loops being HBM-bound on
[B, NL, L] sweeps and being arithmetic on [B, NL, W] words. ctz is
emulated with popcount (cf. the de Bruijn trick the Python prototype uses,
pymatch/util.py:201-208).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

FULL = 0xFFFFFFFF


def pack_rows(rows_bool: jax.Array) -> jax.Array:
    """{0,1}/bool[..., L] -> uint32[..., L//32] (L must be a multiple of 32)."""
    L = rows_bool.shape[-1]
    assert L % 32 == 0, f"packed rows need L % 32 == 0, got {L}"
    W = L // 32
    b = rows_bool.astype(jnp.uint32).reshape(rows_bool.shape[:-1] + (W, 32))
    weights = jnp.left_shift(
        jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32)
    )
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint32)


def _word_starts(W: int) -> jax.Array:
    return 32 * jax.lax.broadcasted_iota(jnp.int32, (W,), 0)


def mask_ge(c: jax.Array, W: int) -> jax.Array:
    """uint32[.., W] with bits set at positions >= c (c may be <0 or >L)."""
    low = jnp.clip(c[..., None] - _word_starts(W), 0, 32)
    shifted = jnp.left_shift(
        jnp.uint32(FULL), jnp.minimum(low, 31).astype(jnp.uint32)
    )
    return jnp.where(low >= 32, jnp.uint32(0), shifted)


def mask_lt(c: jax.Array, W: int) -> jax.Array:
    """uint32[.., W] with bits set at positions < c."""
    return ~mask_ge(c, W)


def ctz32(w: jax.Array) -> jax.Array:
    """Count trailing zeros of each uint32; 32 for zero words.

    popcount((w & -w) - 1): w & -w isolates the lowest set bit 2^t, minus
    one gives t trailing ones; uint32 wraparound makes the w == 0 case come
    out as popcount(0xffffffff) = 32.
    """
    low = w & (~w + jnp.uint32(1))
    return jax.lax.population_count(low - jnp.uint32(1)).astype(jnp.int32)


def first_set_from(packed: jax.Array, c: jax.Array) -> jax.Array:
    """First position >= c with a set bit, else L (register-scan semantics:
    tzcnt of an empty register returns its width, utils.h:168-182).

    packed: uint32[.., W]; c: int32[..]; returns int32[..].
    """
    W = packed.shape[-1]
    L = 32 * W
    masked = packed & mask_ge(c, W)
    idx = _word_starts(W) + ctz32(masked)
    idx = jnp.where(masked == 0, L, idx)
    return jnp.min(idx, axis=-1)


def count_range(packed: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """popcount of positions in [lo, hi) — pop_count_between semantics
    (utils.h:263-270): inverted or out-of-range windows count 0."""
    W = packed.shape[-1]
    m = mask_ge(lo, W) & mask_lt(hi, W)
    return jnp.sum(
        jax.lax.population_count(packed & m), axis=-1, dtype=jnp.int32
    )
