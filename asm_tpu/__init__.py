"""asm_tpu — batched approximate string matching of DNA reads in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
GZHoffie/approximate-string-matching (reference mounted read-only at
/root/reference): three pairwise DNA alignment kernels

  * exact Needleman-Wunsch affine-gap global DP (the accuracy oracle;
    replaces the reference's parasail dependency,
    cf. GASMA/benchmark/benchmark_utils.h:104-150),
  * LEAP / Landau-Vishkin banded "leaping" alignment
    (cf. GASMA/benchmark/LEAP_SIMD/LV_BAG.cpp, SIMD_ED.cpp),
  * GASMA greedy hurdle-matrix highway alignment
    (cf. GASMA/hurdle_matrix.h),

plus the surrounding capability set: device-side 2-bit read encoding
(cf. GASMA/bit_convert.cpp), the SHD pre-filter (LEAP_SIMD/SHD.cpp), CIGAR
emission, the LCM-coverage quality metric (benchmark_coverage.h), a seeded
WFA-style corpus generator (benchmark_dataset.h), the NW-oracle conformance /
benchmark harness (benchmark_utils.h), and a read-mapper shell (GASMA/mapper/).

Unlike the reference — which aligns one pair at a time inside a single
SSE/AVX2 register — every kernel here is a pure batched function over
thousands of read pairs, jit/shard_map-able over a device mesh with
psum-reduced statistics.
"""

__version__ = "0.1.0"

from asm_tpu.config import AlignConfig, AlignmentType, GapPenalty, LeapMode
from asm_tpu.encoding import (
    encode_batch,
    encode_string,
    decode_string,
    pack_bitplanes,
    CODE_A,
    CODE_C,
    CODE_G,
    CODE_T,
    PAD_READ,
    PAD_REF,
)
from asm_tpu.kernels.nw import nw_align, nw_penalty
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.shd import shd_filter
from asm_tpu.kernels.msa import profile_align, profiles_from_alignments

__all__ = [
    "AlignConfig",
    "AlignmentType",
    "GapPenalty",
    "LeapMode",
    "encode_batch",
    "encode_string",
    "decode_string",
    "pack_bitplanes",
    "nw_align",
    "nw_penalty",
    "greedy_align",
    "leap_align",
    "shd_filter",
    "profile_align",
    "profiles_from_alignments",
    "CODE_A",
    "CODE_C",
    "CODE_G",
    "CODE_T",
    "PAD_READ",
    "PAD_REF",
]
