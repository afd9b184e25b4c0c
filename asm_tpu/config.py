"""Typed configuration for alignment kernels.

The reference scatters configuration over compile-time #defines
(GASMA/hurdle_matrix.h:8 MAX_K, GASMA/utils.h:24 MAX_LENGTH), constructor
arguments (hurdle_matrix.h:473-484, LEAP_SIMD/LV_BAG.cpp:65) and ad-hoc CLI
flags. Here it is one frozen dataclass shared by every kernel.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class AlignmentType(enum.IntEnum):
    """cf. GASMA/utils.h:554-558 (alignment_type_t)."""

    GLOBAL = 0
    SEMI_GLOBAL = 1
    LOCAL = 2


class GapPenalty(enum.IntEnum):
    """cf. GASMA/utils.h:563-566 (gap_penalty_t)."""

    LEVENSHTEIN = 0
    AFFINE = 1


class LeapMode(enum.IntEnum):
    """cf. GASMA/benchmark/LEAP_SIMD/LV_BAG.h:38 (ED_modes)."""

    LOCAL = 0
    GLOBAL = 1
    SEMI_FREE_BEGIN = 2
    SEMI_FREE_END = 3


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Shared alignment configuration.

    Attributes:
      x: mismatch penalty (reference `x`, hurdle_matrix.h:183).
      o: gap opening penalty — cost of the FIRST gap character. A gap of
         length L costs ``o + (L - 1) * e`` (cf. switch_lane_penalty,
         GASMA/utils.h:576-579, and parasail's convention used by the
         reference benchmark, benchmark_utils.h:113).
      e: gap extension penalty.
      k: band half-width — greedy explores lanes [-k, k]
         (hurdle_matrix.h:509-512), LEAP explores 2k+3 lanes
         (LV_BAG.cpp:78).
      max_len: maximum sequence length L; sequences are truncated to this,
         mirroring MAX_LENGTH=128 (utils.h:24) / _MAX_LENGTH_=256
         (LV_BAG.h:18). Unlike the reference this is a config knob, not a
         compile-time cap; greedy needs a multiple of 32.
      alignment_type: GLOBAL / SEMI_GLOBAL for greedy.
      match_prob / mismatch_prob / indel_prob: priors for greedy's
         significance heuristic (hurdle_matrix.h:536-538,552-559).
      leap_af_threshold: LEAP maximum accumulated penalty ("energy") —
         reference benchmark uses 200 (benchmark_utils.h:289).
      leap_mode: LEAP edit-distance mode (ED_GLOBAL in the benchmark).
      flip_threshold: morphological denoise threshold for greedy hurdle rows
         (hurdle_matrix.h:453 uses flip_short_hurdles(1), the only value
         the greedy kernel implements; the emulator takes any).
      max_steps: static bound on greedy while-loop trip count (a highway
         step always advances >= 1 column, so max_len is always safe).
    """

    x: int = 1
    o: int = 1
    e: int = 1
    k: int = 3
    max_len: int = 128
    alignment_type: AlignmentType = AlignmentType.GLOBAL
    match_prob: float = 0.80
    mismatch_prob: float = 0.20 / 3
    indel_prob: float = 0.40 / 3
    leap_af_threshold: int = 200
    leap_mode: LeapMode = LeapMode.GLOBAL
    flip_threshold: int = 1
    max_steps: int | None = None

    @property
    def num_lanes(self) -> int:
        """Greedy lane count: lanes -k..k (hurdle_matrix.h:509-512)."""
        return 2 * self.k + 1

    @property
    def leap_total_lanes(self) -> int:
        """LEAP lane count incl. sentinel border lanes (LV_BAG.cpp:78)."""
        return 2 * self.k + 3

    @property
    def steps_bound(self) -> int:
        return self.max_steps if self.max_steps is not None else self.max_len

    @property
    def significance(self) -> tuple[float, float, float]:
        """(match_sig, mismatch_sig, indel_sig), hurdle_matrix.h:536-538."""
        return (
            math.log(self.match_prob / 0.25),
            math.log(self.mismatch_prob / 0.25),
            math.log(self.indel_prob / 2 / 0.25),
        )

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"band half-width k must be >= 0, got {self.k}")
        if self.max_len <= 0:
            raise ValueError(f"max_len must be positive, got {self.max_len}")
        if min(self.x, self.o, self.e) < 0:
            raise ValueError("penalties must be non-negative")


DEFAULT_CONFIG = AlignConfig()

# The configuration of the reference's headline benchmark:
# benchmark bench(1, 1, 1, 3, 1000000, true)  (GASMA/benchmark/benchmark.cpp:22)
BENCHMARK_CONFIG = AlignConfig(x=1, o=1, e=1, k=3)
