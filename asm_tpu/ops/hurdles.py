"""Hurdle-lane construction and lane geometry.

A "lane" is a diagonal of the alignment matrix. The reference builds, per
lane, one SIMD register whose bit p says whether the read and ref characters
on that diagonal at column p differ (a "hurdle"):
_construct_hurdles, GASMA/hurdle_matrix.h:441-455.

Lane/column coordinate system (derived from hurdle_matrix.h:441-455 together
with shift_left = shift toward position 0):

  lane s >= 0: column c compares  A[c]      vs  B[c + s]
  lane s <  0: column c compares  A[c - s]  vs  B[c]

i.e. column c is min(read index, ref index). Positions whose read/ref index
falls outside the true string are ALWAYS hurdles (the sentinels PAD_READ,
PAD_REF, PAD_SHIFT mismatch everything — deterministic where the reference
compares stale buffer bytes).

Here the whole hurdle "matrix" for a BATCH is one int8 array [B, NL, L]
computed with static per-lane shifts — XLA fuses the shift+compare+OR into a
few elementwise passes over the batch; it is never materialized on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from asm_tpu.encoding import PAD_SHIFT
from asm_tpu.ops.bitops import shift_toward_0, shift_away_0


def switch_lane_penalty(l1, l2, o: int, e: int):
    """Leap penalty between lanes: o + e*(|l1-l2|-1), 0 if equal.
    cf. GASMA/utils.h:576-579."""
    d = jnp.abs(l1 - l2)
    return jnp.where(d == 0, 0, o + e * (d - 1))


def switch_forward_column(l1, l2):
    """Columns auto-advanced by leaping l1 -> l2. cf. GASMA/utils.h:587-593."""
    a1, a2 = jnp.abs(l1), jnp.abs(l2)
    same_sign = l1 * l2 >= 0
    return jnp.where(same_sign, jnp.maximum(a1 - a2, 0), a1)


def lane_destination(m, n, lane):
    """Final column of a lane (alignment endpoint clamp).
    cf. _calculate_destination, GASMA/hurdle_matrix.h:58-68."""
    m = jnp.asarray(m)
    n = jnp.asarray(n)
    ge = m >= n
    dest_ge = jnp.where(
        lane > 0, n - lane, jnp.where(lane >= n - m, n, m + lane)
    )
    dest_lt = jnp.where(
        lane < 0, m + lane, jnp.where(lane <= n - m, m, n - lane)
    )
    return jnp.where(ge, dest_ge, dest_lt)


def build_greedy_lanes(
    read_codes: jax.Array, ref_codes: jax.Array, k: int
) -> jax.Array:
    """Hurdle rows for greedy lanes -k..k: int8[B, 2k+1, L].

    Row index i corresponds to lane (i - k). Batched equivalent of
    _construct_hurdles (GASMA/hurdle_matrix.h:441-455): per-lane shifted
    compare, batched. The reference XORs two bit-planes; comparing int8
    codes directly is the same boolean and lets XLA keep everything in one
    fused elementwise pass.
    """
    rows = []
    for lane in range(-k, k + 1):
        if lane < 0:
            a = shift_toward_0(read_codes, -lane, fill=PAD_SHIFT)
            b = ref_codes
        else:
            a = read_codes
            b = shift_toward_0(ref_codes, lane, fill=PAD_SHIFT)
        rows.append((a != b).astype(jnp.int8))
    return jnp.stack(rows, axis=-2)


def build_leap_lanes(
    read_codes: jax.Array, ref_codes: jax.Array, k: int
) -> jax.Array:
    """Hurdle rows for LEAP's 2k+3 lanes: int8[B, 2k+3, L].

    LEAP's coordinate (LV_BAG.cpp:9-23) is pos = max(read idx, ref idx):
    lane l < mid compares A[pos - (mid-l)] vs B[pos]; lane l > mid compares
    A[pos] vs B[pos - (l-mid)], with mid = k+1. Border lanes 0 and 2k+2 are
    sentinels (never walked, LV_BAG.cpp:131) — filled with all-hurdles.
    Positions whose indices fall before 0 mismatch by construction
    (PAD_SHIFT fill), replacing the reference's out-of-bounds reads.
    """
    mid = k + 1
    rows = []
    for lane in range(2 * k + 3):
        if lane == 0 or lane == 2 * k + 2:
            rows.append(jnp.ones_like(read_codes))
            continue
        a_off = max(mid - lane, 0)
        b_off = max(lane - mid, 0)
        a = shift_away_0(read_codes, a_off, fill=PAD_SHIFT)
        b = shift_away_0(ref_codes, b_off, fill=PAD_SHIFT)
        rows.append((a != b).astype(jnp.int8))
    return jnp.stack(rows, axis=-2)
