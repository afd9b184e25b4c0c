"""DNA sequence encoding for device kernels.

The reference packs ACGT strings into two SIMD bit-planes with a 7-stage
in-register shuffle transpose (sse3_convert2bit1, GASMA/bit_convert.cpp:248-369;
code A=00, C=01, G=10, T=11 — bit_convert.cpp:343-354, pymatch/util.py:13).

The device layout is batch-major: a corpus of B read/ref pairs becomes

  codes: int8[B, L]    2-bit base codes 0..3, padded with sentinels
  length: int32[B]     true lengths (<= L)

Reads are padded with PAD_READ (4) and refs with PAD_REF (5) beyond their true
length, so any comparison that touches padding is a guaranteed mismatch. This
replaces the reference's undefined behaviour of comparing leftover buffer
garbage past the string end (hurdle_matrix.h:497 strncpy into a reused
buffer) with deterministic semantics: past-the-end is always a hurdle.

``pack_bitplanes`` additionally produces the 2-bit-plane layout
(uint32[B, L/32]) used by the Pallas kernels, where bit p of word w is bit0/1
of the code of base 32*w + p — the same bit-plane idea as the reference, laid
out for 32-bit device words instead of __m128i registers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3
PAD_READ = 4  # sentinel for read padding
PAD_REF = 5  # sentinel for ref padding
PAD_SHIFT = 6  # sentinel shifted in by lane-shift ops (mismatches everything)

_BASE_TO_CODE = np.full(256, CODE_A, dtype=np.int8)  # non-ACGT behaves like 'A'
for _ch, _code in (("A", CODE_A), ("C", CODE_C), ("G", CODE_G), ("T", CODE_T),
                   ("a", CODE_A), ("c", CODE_C), ("g", CODE_G), ("t", CODE_T)):
    _BASE_TO_CODE[ord(_ch)] = _code
_CODE_TO_BASE = np.array(list("ACGT") + ["N"] * 4, dtype="U1")


def encode_string(s: str, max_len: int, pad: int = PAD_READ) -> np.ndarray:
    """Encode one ASCII DNA string to int8 codes, truncated/padded to max_len."""
    raw = np.frombuffer(s[:max_len].encode("ascii"), dtype=np.uint8)
    out = np.full(max_len, pad, dtype=np.int8)
    out[: raw.size] = _BASE_TO_CODE[raw]
    return out


def decode_string(codes: np.ndarray, length: int | None = None) -> str:
    codes = np.asarray(codes)
    if length is not None:
        codes = codes[:length]
    else:
        codes = codes[codes < 4]
    return "".join(_CODE_TO_BASE[codes])


def decode_batch(codes: np.ndarray, lens: np.ndarray) -> list[str]:
    """Vectorized `decode_string` over a whole [N, L] batch: one LUT
    gather, then a cheap per-row tobytes().decode() (the per-character
    Python join dominated mapper SAM emission at 100k reads)."""
    codes = np.asarray(codes)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    ch = lut[np.clip(codes, 0, 4)]
    return [ch[i, : int(lens[i])].tobytes().decode()
            for i in range(codes.shape[0])]


def encode_batch(
    reads: list[str],
    refs: list[str],
    max_len: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side batch encode: returns (read_codes, read_len, ref_codes, ref_len).

    Sequences longer than max_len are truncated, mirroring the reference
    (hurdle_matrix.h:487-488, SIMD_ED.cpp:141-142).
    """
    b = len(reads)
    assert len(refs) == b
    read_codes = np.full((b, max_len), PAD_READ, dtype=np.int8)
    ref_codes = np.full((b, max_len), PAD_REF, dtype=np.int8)
    read_len = np.empty(b, dtype=np.int32)
    ref_len = np.empty(b, dtype=np.int32)
    for i, (a, bb) in enumerate(zip(reads, refs)):
        m = min(len(a), max_len)
        n = min(len(bb), max_len)
        read_codes[i, :m] = _BASE_TO_CODE[
            np.frombuffer(a[:m].encode("ascii"), dtype=np.uint8)
        ]
        ref_codes[i, :n] = _BASE_TO_CODE[
            np.frombuffer(bb[:n].encode("ascii"), dtype=np.uint8)
        ]
        read_len[i] = m
        ref_len[i] = n
    return read_codes, read_len, ref_codes, ref_len


def encode_ascii_device(
    ascii_bytes: jax.Array, length: jax.Array, pad: int
) -> jax.Array:
    """Device-side encode of uint8 ASCII [B, L] -> int8 codes [B, L].

    Batched equivalent of sse3_convert2bit1 (GASMA/bit_convert.cpp:248):
    instead of a shuffle-transpose into __m128i bit-planes, a vectorized
    arithmetic map runs over the whole batch at once. The 2-bit
    code is extracted from the ASCII byte: A=0x41->00, C=0x43->01, G=0x47->10,
    T=0x54->11 equals bits (b>>1 ^ b>>2) & 3 ... implemented as a comparison
    cascade for clarity (XLA fuses it into a handful of elementwise ops).
    """
    b = ascii_bytes
    codes = jnp.where(
        (b == ord("C")) | (b == ord("c")), CODE_C,
        jnp.where(
            (b == ord("G")) | (b == ord("g")), CODE_G,
            jnp.where((b == ord("T")) | (b == ord("t")), CODE_T, CODE_A),
        ),
    ).astype(jnp.int8)
    pos = jax.lax.broadcasted_iota(jnp.int32, ascii_bytes.shape, len(ascii_bytes.shape) - 1)
    return jnp.where(pos < length[..., None], codes, jnp.int8(pad))


def pack_bitplanes(codes: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Pack int8 codes [.., L] into 2 bit-planes uint32[.., L/32].

    Plane 0 holds bit0 of each code, plane 1 holds bit1 (the reference's
    two-__m128i representation, GASMA/bit_convert.h:17-21). Padding codes
    (>= 4) have bit2 set and are NOT representable; callers that need
    padding-aware comparisons must carry the length masks separately.
    """
    L = codes.shape[-1]
    assert L % 32 == 0, "bitplane packing requires L % 32 == 0"
    c = codes.astype(jnp.uint32)
    bit0 = (c & 1).reshape(codes.shape[:-1] + (L // 32, 32))
    bit1 = ((c >> 1) & 1).reshape(codes.shape[:-1] + (L // 32, 32))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    plane0 = (bit0 * weights).sum(axis=-1, dtype=jnp.uint32)
    plane1 = (bit1 * weights).sum(axis=-1, dtype=jnp.uint32)
    return plane0, plane1


def pack_planes_t(codes: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(bit0, bit1, valid) planes, WORD-MAJOR uint32[L/32, B], from int8
    codes [B, L].

    Same plane bit layout as pack_bitplanes plus a validity plane (bit p
    set iff code 32*w+p is a real base < 4 — every sentinel PAD_READ=4,
    PAD_REF=5, PAD_SHIFT=6 has bit2 set, so "valid" is one AND) — the batched
    analogue of the reference's in-register shuffle transpose
    (sse3_convert2bit1, GASMA/bit_convert.cpp:248-369).

    The codes are transposed once to position-major [L, B] — minor dim =
    batch — and each output word is a 32-row shift-OR chain of full-width
    rows, which XLA fuses into one pass per output.
    """
    B, L = codes.shape
    assert L % 32 == 0, "bitplane packing requires L % 32 == 0"
    W = L // 32
    ct = codes.T.astype(jnp.uint32)  # [L, B] position-major
    out0, out1, outv = [], [], []
    for w in range(W):
        acc0 = acc1 = accv = jnp.zeros((B,), jnp.uint32)
        for b in range(32):
            c = ct[32 * w + b]
            acc0 = acc0 | ((c & 1) << b)
            acc1 = acc1 | (((c >> 1) & 1) << b)
            accv = accv | (((~c >> 2) & 1) << b)
        out0.append(acc0)
        out1.append(acc1)
        outv.append(accv)
    return jnp.stack(out0), jnp.stack(out1), jnp.stack(outv)
