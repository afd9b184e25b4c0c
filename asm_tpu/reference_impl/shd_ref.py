"""Scalar emulator of the reference SHD pre-filter (LEAP_SIMD/SHD.cpp).

Mirrors the compiled code mechanically on Python big-ints so the batched
batched kernel (asm_tpu.kernels.shd) has a conformance oracle, exactly like
greedy_ref/leap_ref anchor the other kernels. Three entry points:

  flip_false_zero      — SHD.cpp:21-88   (MASK_SRS shuffle-LUT cascade)
  bit_vec_filter       — SHD.cpp:157-239 (two-bit-plane register variant;
                         the AVX twin :241-333 is the same algorithm at
                         width 256 with a LANE-SPLIT funnel shift, see
                         shift_right_avx note below)
  bit_vec_filter_masks — SHD.cpp:335-385 (the variant SIMD_ED's gate
                         actually calls, SIMD_ED.cpp:270,489) — including
                         its two quirks, reproduced deliberately:
                         (a) flip_false_zero is applied to the MASK, not
                             the diff (SHD.cpp:364) — a no-op on the
                             contiguous BEG&END masks, so the production
                             gate performs NO speckle removal;
                         (b) at j == max_error the error is 0 and the code
                             reads MASK_AVX_BEG[-1] (SHD.cpp:360) — 32
                             bytes BEFORE the table. With the reference's
                             link layout (mask.cpp declaration order) that
                             is the last two rows of __MASK_SSE_END_:
                             bits {0..254} (see DEFAULT_OOB_ROW). Pass
                             `oob_row` to override with the compiled
                             binary's dumped value when validating.

Bit conventions (SHD.cpp:17-19 "by little endians"): bit p of a plane is
string position p; `shift_right_sse(v, n)` moves bits UP (result bit p =
input bit p-n, positions shift right), `shift_left_sse` moves bits DOWN.
`_mm256_slli_si256`-based carry makes the AVX funnel shifts LOSE carries
across the 128-bit lane boundary (shift.cpp:32-45) — mirrored here.

MASK_SRS (mask.cpp:427-432) maps each low nibble to itself with interior
0-runs of length <= 2 (flanked by 1s within the 4-bit window) filled; the
i=0..3 rounds + the 4-bit cross pass slide that window over every offset.
POPCOUNT_SHD (popcount.cpp:41-73) counts per-nibble 1-run starts EXCEPT
value 6 (0110) which counts 2 — the table is authoritative, quirk and all.
"""

from __future__ import annotations

MASK_SRS = (0x00, 0x01, 0x02, 0x03, 0x04, 0x07, 0x06, 0x07,
            0x08, 0x0F, 0x0E, 0x0F, 0x0C, 0x0F, 0x0E, 0x0F)
POPCOUNT_SHD = (0, 1, 1, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1, 2, 1, 1)

# bits {0..254}: the 32 bytes preceding __MASK_AVX_BEG_ in the reference's
# ACTUAL link layout (dumped by tools/validate_vs_reference.py's shd_driver)
# are the last row of __MASK_AVX_END_ (0xff x31, 0x7f — mask.cpp:168), i.e.
# the compiler placed __MASK_AVX_END_ before __MASK_AVX_BEG_ in memory. For
# lengths <= 255 the row ANDs to all-ones, so the error==0 lane is
# effectively unmasked — the benign reading of the OOB quirk.
DEFAULT_OOB_ROW = (1 << 255) - 1


def _bytes_map_srs(v: int, nbytes: int) -> int:
    """_mm_shuffle_epi8(MASK_SRS, v & 0x7f-per-byte): LUT of each byte's
    low nibble (high nibble of the index is ignored by pshufb)."""
    out = 0
    for i in range(nbytes):
        b = (v >> (8 * i)) & 0xFF
        out |= MASK_SRS[b & 0x0F] << (8 * i)
    return out


def _srli_epi16(v: int, n: int, width: int) -> int:
    """Per-16-bit-lane right shift (bits move DOWN within each lane)."""
    out = 0
    for i in range(width // 16):
        lane = (v >> (16 * i)) & 0xFFFF
        out |= (lane >> n) << (16 * i)
    return out


def _slli_epi16(v: int, n: int, width: int) -> int:
    """Per-16-bit-lane left shift (bits move UP within each lane)."""
    out = 0
    for i in range(width // 16):
        lane = (v >> (16 * i)) & 0xFFFF
        out |= ((lane << n) & 0xFFFF) << (16 * i)
    return out


def _shift_up(v: int, n: int, width: int) -> int:
    """shift_right_sse/avx(v, n) for n < 64: bits move UP. The AVX version
    carries across the 64-bit split inside each 128-bit lane but NOT
    across the 128-bit lane boundary (shift.cpp:40-44 uses
    _mm256_slli_si256, which is per-lane)."""
    if width == 128:
        return (v << n) & ((1 << 128) - 1)
    lo = (v & ((1 << 128) - 1)) << n & ((1 << 128) - 1)
    hi = ((v >> 128) << n) & ((1 << 128) - 1)
    return lo | (hi << 128)


def _shift_down(v: int, n: int, width: int) -> int:
    """shift_left_sse/avx(v, n): bits move DOWN; same AVX lane split."""
    if width == 128:
        return v >> n
    lo = (v & ((1 << 128) - 1)) >> n
    hi = (v >> 128) >> n
    return lo | (hi << 128)


def flip_false_zero(vec: int, width: int = 128) -> int:
    """SHD.cpp:21-88 (SSE) / :90-155 (AVX): fill interior 0-runs of length
    <= 2 flanked by 1s, via the MASK_SRS window cascade."""
    nbytes = width // 8
    b7f = int.from_bytes(b"\x7f" * nbytes, "little")

    vec |= _bytes_map_srs(vec & b7f, nbytes)
    for i in range(1, 4):
        s = _srli_epi16(vec, i, width) & b7f
        s = _bytes_map_srs(s, nbytes)
        vec |= _slli_epi16(s, i, width)

    sv = _shift_up(vec, 4, width)
    sv |= _bytes_map_srs(sv & b7f, nbytes)
    for i in range(1, 4):
        s = _srli_epi16(sv, i, width) & b7f
        s = _bytes_map_srs(s, nbytes)
        sv |= _slli_epi16(s, i, width)

    return vec | _shift_down(sv, 4, width)


def popcount_shd(v: int, width: int = 128) -> int:
    """popcount_SHD_sse/avx (popcount.cpp:83-200 core, POPCOUNT_SHD map):
    sum of the table over every 4-bit nibble."""
    total = 0
    for i in range(width // 4):
        total += POPCOUNT_SHD[(v >> (4 * i)) & 0xF]
    return total


def _end_mask(length: int, width: int) -> int:
    """MASK_SSE_END[length] / MASK_AVX_END[length]: low `length` bits
    (all ones when length >= width, SHD.cpp:161-165)."""
    if length >= width:
        return (1 << width) - 1
    return (1 << length) - 1


def _beg_mask(j: int, width: int) -> int:
    """MASK_SSE_BEG[j-1] / MASK_AVX_BEG[j-1]: clears the low j bits."""
    return ((1 << width) - 1) & ~((1 << j) - 1)


def planes_from_codes(codes, length: int, width: int = 128):
    """(bit0, bit1) planes from int codes — sse/avx_convert2bit layout
    (LEAP_SIMD/bit_convert.cpp:212,335): bit p = bit0/bit1 of code p."""
    p0 = p1 = 0
    for p, c in enumerate(codes[:min(length, width)]):
        p0 |= (int(c) & 1) << p
        p1 |= ((int(c) >> 1) & 1) << p
    return p0, p1


def calculate_masks_ref(a_codes, b_codes, k: int, width: int = 256):
    """SIMD_ED::calculate_masks (SIMD_ED.cpp:180-212): per-lane hamming
    masks for lanes 1..2k+1 (mid = k+1); one side's planes shifted UP by
    |i - mid| with the lane-split AVX funnel (no 127->128 carry)."""
    a0, a1 = planes_from_codes(a_codes, width, width)
    b0, b1 = planes_from_codes(b_codes, width, width)
    mid = k + 1
    masks = []
    for i in range(1, 2 * k + 2):
        sh = abs(i - mid)
        sa0, sa1, sb0, sb1 = a0, a1, b0, b1
        if i < mid:
            sb0 = _shift_up(sb0, sh, width)
            sb1 = _shift_up(sb1, sh, width)
        elif i > mid:
            sa0 = _shift_up(sa0, sh, width)
            sa1 = _shift_up(sa1, sh, width)
        masks.append((sa0 ^ sb0) | (sa1 ^ sb1))
    return masks


def bit_vec_filter(read0: int, read1: int, ref0: int, ref1: int,
                   length: int, max_error: int, width: int = 128) -> bool:
    """bit_vec_filter_sse (SHD.cpp:157-239) / _avx (:241-333): True = the
    pair MAY be within max_error (keep), False = certainly rejected."""
    mask = _end_mask(length, width)
    read0 &= mask
    read1 &= mask
    ref0 &= mask
    ref1 &= mask

    diff = (read0 ^ ref0) | (read1 ^ ref1)
    diff = flip_false_zero(diff, width)

    for j in range(1, max_error + 1):
        tm = _beg_mask(j, width) & mask
        # right-shift read: result bit p compares read[p-j] vs ref[p]
        d = (((_shift_up(read0, j, width)) ^ ref0)
             | ((_shift_up(read1, j, width)) ^ ref1)) & tm
        diff &= flip_false_zero(d, width)
        # right-shift ref
        d = (((_shift_up(ref0, j, width)) ^ read0)
             | ((_shift_up(ref1, j, width)) ^ read1)) & tm
        diff &= flip_false_zero(d, width)

    return popcount_shd(diff, width) <= max_error


def bit_vec_filter_masks(xor_masks, length: int, max_error: int,
                         width: int = 256,
                         oob_row: int = DEFAULT_OOB_ROW) -> bool:
    """bit_vec_filter_avx(xor_masks, ...) (SHD.cpp:335-385) — the variant
    SIMD_ED's SHD gate calls with hamming_masks+1 (SIMD_ED.cpp:270,489).
    xor_masks[j] for j in 0..2*max_error are the per-lane hamming masks;
    quirks (a) and (b) from the module docstring are reproduced."""
    mask = _end_mask(length, width)
    wmask = (1 << width) - 1
    diff = wmask
    for j in range(2 * max_error + 1):
        error = abs(j - max_error)
        beg = (oob_row & wmask) if error == 0 else _beg_mask(error, width)
        tm = beg & mask
        temp_diff = int(xor_masks[j]) & tm
        flip_false_zero(tm, width)  # reference flips the MASK: a no-op
        diff &= temp_diff
    return popcount_shd(diff, width) <= max_error
