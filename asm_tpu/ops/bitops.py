"""Vectorized replacements for the reference's bit-parallel primitives.

The reference works on one 128/256-bit SIMD register per hurdle row, where
bit position p = string position p (LSB-first) and queries are answered with
x86 bit tricks:

  first_one / first_zero   -> _tzcnt_u64 scan        (GASMA/utils.h:168-191)
  pop_count_between(f, t)  -> funnel shift + POPCNT  (GASMA/utils.h:263-270)
  flip_short_hurdles/matches -> shifted AND/OR masks (GASMA/utils.h:200-240)

Instead of one private register per problem we hold a whole BATCH of rows
as int8 arrays [.., L] (one string position per element, problems across
the batch axis) and precompute per-row scan structures
once, turning every per-step bit query into an O(1) gather:

  next_one_index / next_zero_index : [.., L+1] "first set/unset index >= p"
      (a reverse cummin — replaces every tzcnt query)
  prefix_count : [.., L+1] cumulative popcount — pop_count_between(f, t)
      becomes cum[t] - cum[f] (two gathers)

This is the key algorithmic translation called out in SURVEY.md §7: the
reference pays O(lanes) register scans per greedy step; we pay one cumsum +
cummin per row per PAIR and O(1) per query.

Position-space shift conventions (note the reference names are inverted
because x86 little-endian "left shift" moves bits AWAY from position 0):

  shift_toward_0(x, s)[p] = x[p+s]   == reference shift_left  (utils.h:143)
  shift_away_0(x, s)[p]   = x[p-s]   == reference shift_right (utils.h:131)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shift_toward_0(x: jax.Array, s: int, fill=0) -> jax.Array:
    """out[p] = x[p+s]; positions past the end filled with `fill`."""
    if s == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (s,), fill, dtype=x.dtype)
    return jnp.concatenate([x[..., s:], pad], axis=-1)


def shift_away_0(x: jax.Array, s: int, fill=0) -> jax.Array:
    """out[p] = x[p-s]; positions before 0 filled with `fill`."""
    if s == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (s,), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-s]], axis=-1)


def flip_short_hurdles(h: jax.Array, threshold: int = 1) -> jax.Array:
    """Drop isolated hurdles: a 1 at p survives only if a neighbour within
    `threshold` positions is also 1 (zeros shifted in at the boundaries).

    Faithful to GASMA/utils.h:200-216: threshold=1 keeps h & (h<<1 | h>>1);
    threshold=2 keeps h & (h<<1 | h>>1 | h<<2 | h>>2).
    """
    near = shift_toward_0(h, 1) | shift_away_0(h, 1)
    if threshold > 1:
        near = near | shift_toward_0(h, 2) | shift_away_0(h, 2)
    return h & near


def flip_short_matches(h: jax.Array, threshold: int = 1) -> jax.Array:
    """Fill isolated matches: a 0 at p is flipped to 1 if both neighbours are
    1 (ONES shifted in at the boundaries — the reference uses shift_*_one
    which ORs a boundary bit in, GASMA/utils.h:155-163,223-240).

    threshold=2 replicates the reference literally, including its quirk of
    deriving r2 from l2 (utils.h:228-229): l2 = (h<<1 with low-one)<<1 with
    low-one... kept bit-exact rather than "fixed".
    """

    def toward_one(x):  # reference shift_left_one: shift toward 0, set top bit
        out = shift_toward_0(x, 1)
        return out.at[..., -1].set(1)

    def away_one(x):  # reference shift_right_one: shift away from 0, set bit 0
        out = shift_away_0(x, 1)
        return out.at[..., 0].set(1)

    l1 = toward_one(h)
    r1 = away_one(h)
    mask1 = l1 & r1
    if threshold > 1:
        l2 = toward_one(l1)
        r2 = away_one(l2)  # sic — reference utils.h:229 shifts l2, not r1
        mask2 = (l1 & r2) | (l2 & r1)
        return h | mask1 | mask2
    return h | mask1


def next_one_index(h: jax.Array) -> jax.Array:
    """For row(s) h in {0,1}[.., L] return n[.., L+1] with
    n[p] = min{q >= p : h[q] == 1}, or L if none — the precomputed answer to
    every `first_one` query (GASMA/utils.h:168-182: tzcnt returns the
    register width when no bit is set; here that is L).
    """
    L = h.shape[-1]
    idx = jnp.where(
        h.astype(bool),
        jax.lax.broadcasted_iota(jnp.int32, h.shape, h.ndim - 1),
        jnp.int32(L),
    )
    # suffix min: reverse, cummin, reverse
    ax = h.ndim - 1
    nxt = jnp.flip(jax.lax.cummin(jnp.flip(idx, axis=ax), axis=ax), axis=ax)
    tail = jnp.full(h.shape[:-1] + (1,), L, dtype=jnp.int32)
    return jnp.concatenate([nxt, tail], axis=-1)


def next_zero_index(h: jax.Array) -> jax.Array:
    """n[p] = min{q >= p : h[q] == 0}, or L if none (first_zero queries)."""
    return next_one_index(1 - h)


def prefix_count(h: jax.Array) -> jax.Array:
    """cum[.., L+1] with cum[p] = sum(h[..., :p]) — prefix popcount."""
    zeros = jnp.zeros(h.shape[:-1] + (1,), dtype=jnp.int32)
    return jnp.concatenate(
        [zeros, jnp.cumsum(h.astype(jnp.int32), axis=-1)], axis=-1
    )


def count_between(cum: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """pop_count_between(lo, hi) on the row whose prefix counts are `cum`
    ([.., L+1]); lo/hi are [..] int32 and may be out of range or inverted —
    matching the saturating semantics of GASMA/utils.h:263-270 (an inverted
    or out-of-range window counts 0).
    """
    L = cum.shape[-1] - 1
    lo_c = jnp.clip(lo, 0, L)
    hi_c = jnp.clip(hi, 0, L)
    a = jnp.take_along_axis(cum, lo_c[..., None], axis=-1)[..., 0]
    b = jnp.take_along_axis(cum, hi_c[..., None], axis=-1)[..., 0]
    return jnp.maximum(b - a, 0)


def gather_last(x: jax.Array, idx: jax.Array) -> jax.Array:
    """x[.., idx] along the last axis; idx clipped into range."""
    idx_c = jnp.clip(idx, 0, x.shape[-1] - 1)
    return jnp.take_along_axis(x, idx_c[..., None], axis=-1)[..., 0]
