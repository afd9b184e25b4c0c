"""Batched Shifted-Hamming-Distance (SHD) pre-filter.

Batched equivalent of bit_vec_filter_sse/avx
(GASMA/benchmark/LEAP_SIMD/SHD.cpp:157-385): a cheap gate that rejects read
pairs whose edit distance certainly exceeds max_error before running the
full LEAP/NW kernels (used optionally by SIMD_ED::run_levenshtein/affine,
SIMD_ED.cpp:270,489).

Conformance anchor: asm_tpu.reference_impl.shd_ref, which is itself
validated verdict-for-verdict against the COMPILED reference filter
(tools/validate_vs_reference.py, build_shd_driver). Semantics mirrored
exactly:

  * the pair "length" is the BUFFER length max(|read|, |ref|)
    (SIMD_ED::load_reads buffer_length, SIMD_ED.cpp:139); the shorter
    string's tail is zero-padded, which the reference's converter encodes
    as 'A' — so padding codes here are mapped to code 0 before comparing;
  * per shift j in 1..max_error (both directions), the Hamming mask is
    ANDed after clearing the low j positions (MASK_SSE_BEG) and everything
    past `length` (MASK_SSE_END);
  * "flip false zeros" (SHD.cpp:21-88): interior 0-runs of length <= 2
    flanked by 1s are filled — the closed form of the MASK_SRS window
    cascade (every 4-bit window at every offset, OR-accumulated; fills
    never create new flanks, so one simultaneous pass is the closure);
  * the final count uses the POPCOUNT_SHD table (popcount.cpp:41-73):
    1-run starts per 4-bit nibble, PLUS ONE for nibble value 6 (0b0110)
    — the table's one irregular entry, reproduced as-is.

The production gate variant SIMD_ED actually calls (SHD.cpp:335-385 on
hamming_masks) applies flip_false_zero to the MASK rather than the diff
(a no-op), i.e. it performs no speckle removal — `shd_gate_masks` mirrors
that variant for LEAP-style lane masks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asm_tpu.ops.bitops import shift_toward_0, shift_away_0


def _flip_false_zeros(v: jax.Array) -> jax.Array:
    """Fill interior 0-runs of length <= 2 bounded by 1s (flip_false_zero,
    SHD.cpp:21-88). Fills only ever happen between ORIGINAL 1s, so one
    simultaneous pass is the cascade's closure — EXCEPT at the register
    top: the cascade's sliding 4-bit windows only reach offset width-5
    (the cross pass cannot shift windows past the register end,
    SHD.cpp:61-84), so a run whose last zero sits at bit >= width-2 is
    never filled. Mirrored here with position bounds (verified bit-exact
    vs shd_ref.flip_false_zero in tests/test_shd_conformance)."""
    L = v.shape[-1]
    pos = jax.lax.broadcasted_iota(jnp.int32, v.shape, v.ndim - 1)
    l1 = shift_toward_0(v, 1, fill=0)
    r1 = shift_away_0(v, 1, fill=0)
    l2 = shift_toward_0(v, 2, fill=0)
    r2 = shift_away_0(v, 2, fill=0)
    single = ((r1 & l1) == 1) & (pos <= L - 3)  # 1 0 1, run top <= L-3
    dleft = ((r1 & l2) == 1) & (pos <= L - 4)   # left zero of 1 0 0 1
    dright = ((r2 & l1) == 1) & (pos <= L - 3)  # right zero of 1 0 0 1
    return jnp.where(
        (v == 0) & (single | dleft | dright), 1, v
    ).astype(v.dtype)


def _popcount_shd(v: jax.Array) -> jax.Array:
    """POPCOUNT_SHD semantics (popcount.cpp:41-73): per 4-bit nibble,
    count 1-run starts (a run spanning a nibble boundary counts once per
    nibble) plus one extra for the irregular table entry 6 (0b0110)."""
    L = v.shape[-1]
    assert L % 4 == 0
    prev = shift_away_0(v, 1, fill=0)
    pos = jax.lax.broadcasted_iota(jnp.int32, v.shape, v.ndim - 1)
    starts = (v == 1) & ((prev == 0) | (pos % 4 == 0))
    count = starts.sum(axis=-1).astype(jnp.int32)
    nib = v.reshape(v.shape[:-1] + (L // 4, 4)).astype(jnp.int32)
    is6 = ((nib[..., 0] == 0) & (nib[..., 1] == 1)
           & (nib[..., 2] == 1) & (nib[..., 3] == 0))
    return count + is6.sum(axis=-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_error",))
def shd_filter(read_codes, read_len, ref_codes, ref_len, max_error: int = 3):
    """Returns bool[B]: True = pair may be within max_error (keep),
    False = certainly rejected. cf. bit_vec_filter_sse, SHD.cpp:157-239."""
    B, L = read_codes.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    length = jnp.minimum(
        jnp.maximum(read_len.astype(jnp.int32), ref_len.astype(jnp.int32)), L
    )
    len_mask = (pos < length[:, None]).astype(jnp.int8)

    # zero-padded buffers: the reference strncpy's into zeroed space and
    # byte 0 encodes as 'A' (bit_convert.cpp:305-320), so padding codes
    # (>= 4) behave as code 0 inside the filter
    rc = jnp.where(read_codes < 4, read_codes, 0)
    fc = jnp.where(ref_codes < 4, ref_codes, 0)

    def ham(a, b):
        return (a != b).astype(jnp.int8)

    diff = _flip_false_zeros(ham(rc, fc) & len_mask)
    for j in range(1, max_error + 1):
        beg_mask = (pos >= j).astype(jnp.int8) & len_mask
        # "right shift read": position p compares read[p-j] vs ref[p]
        d1 = ham(shift_away_0(rc, j, fill=0), fc) & beg_mask
        d2 = ham(shift_away_0(fc, j, fill=0), rc) & beg_mask
        diff = diff & _flip_false_zeros(d1)
        diff = diff & _flip_false_zeros(d2)

    return _popcount_shd(diff) <= max_error


@functools.partial(jax.jit, static_argnames=("max_error",))
def shd_gate_masks(lane_masks, length, max_error: int):
    """The gate variant SIMD_ED's run actually calls
    (bit_vec_filter_avx(xor_masks,...), SHD.cpp:335-385): AND of the
    2*max_error+1 per-lane hamming masks, each cleared below |j -
    max_error| and past `length`; NO speckle removal (the reference flips
    the MASK, a no-op — SHD.cpp:364, quirk documented in shd_ref); then
    the POPCOUNT_SHD count <= max_error.

    lane_masks: {0,1} int8[B, 2*max_error+1, L]; length: int32[B].
    The error==0 lane is unmasked below, matching the reference's
    out-of-bounds MASK_AVX_BEG[-1] row (all ones up to bit 254 in its
    link layout — shd_ref.DEFAULT_OOB_ROW) for every length <= 255.
    """
    B, NLANES, L = lane_masks.shape
    assert NLANES == 2 * max_error + 1
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    len_mask = (pos < jnp.minimum(length, L)[:, None]).astype(jnp.int8)
    diff = jnp.ones((B, L), jnp.int8)
    for j in range(NLANES):
        error = abs(j - max_error)
        tm = (pos >= error).astype(jnp.int8) & len_mask
        diff = diff & (lane_masks[:, j, :] & tm)
    return _popcount_shd(diff) <= max_error
