"""Difficulty-aware batch scheduling for lockstep kernels.

The greedy kernel advances a block of pairs in lockstep: its while_loop
runs until the SLOWEST pair in the block converges (the per-block exit in
asm_tpu.kernels.greedy). With randomly ordered corpora many blocks
contain a tail pair and pay close to the worst-case step count. Ordering
the corpus by a difficulty proxy groups pairs of similar step count into
the same block: easy blocks then exit in 2-3 iterations and only the few
genuinely hard blocks run long —
the lockstep analogue of sequence-length bucketing in batched inference.

This is a scheduling concern, not an algorithm change: per-pair results
are unchanged, only their order. `difficulty_order` returns the
permutation (host-side numpy, cheap: one vectorized pass over the codes);
callers that need input order back apply `inverse_permutation` to the
permutation and reindex host-side. The reference has no analogue — it
walks one pair at a time, so order never matters (benchmark_utils.h:373).

The proxy: greedy step count grows with the number of denoised hurdle
clusters along the walked path plus the number of lane switches. Counting
adjacent mismatch pairs on lane 0 tracks both: mismatch-only pairs
contribute their >= 2-wide clusters (isolated mismatches are erased by
flip_short_hurdles(1) and cost no step), while indel pairs mismatch
almost everywhere on lane 0 past the first indel, pushing them to the
hard end — exactly where their lane-switching walks belong.
"""

from __future__ import annotations

import numpy as np


def difficulty_proxy(read_codes, read_len, ref_codes, ref_len) -> np.ndarray:
    """int32[B] monotone-ish proxy for per-pair greedy step count."""
    rc = np.asarray(read_codes)
    fc = np.asarray(ref_codes)
    d = rc != fc  # pads (4 vs 5) mismatch, matching kernel semantics
    return (d[:, 1:] & d[:, :-1]).sum(axis=1, dtype=np.int32)


def difficulty_order(read_codes, read_len, ref_codes, ref_len) -> np.ndarray:
    """Permutation that sorts the batch easy -> hard (stable).

    Native fast path: parallel proxy + stable counting sort in C++
    (native/src/hostmem.cpp asm_difficulty_sort) — bit-identical to the
    numpy stable argsort below (tests/test_parallel.py pins this), but
    without the multi-GB temporary that faults in at ~16 MB/s here.
    """
    rc = np.ascontiguousarray(read_codes)
    fc = np.ascontiguousarray(ref_codes)
    if (rc.dtype == np.int8 and fc.dtype == np.int8 and rc.ndim == 2
            and rc.shape == fc.shape):
        from asm_tpu.native import load_native

        lib = load_native()
        if lib is not None:
            perm = np.empty(rc.shape[0], np.int64)
            lib.asm_difficulty_sort(rc, fc, rc.shape[0], rc.shape[1],
                                    perm, 0)
            return perm
    return np.argsort(
        difficulty_proxy(read_codes, read_len, ref_codes, ref_len),
        kind="stable",
    )


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """inv with inv[perm[i]] = i — maps sorted-order results back."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def quantized_step_bounds(steps: np.ndarray, chunk: int,
                          slack: int = 2, floor: int = 4) -> list[int]:
    """Per-chunk loop bounds from measured per-pair trip counts, rounded
    up to powers of two.

    Used by the bench's measured-steps order cache: `steps` must already
    be SORTED (the cached schedule feeds pairs to chunks in sorted
    order). Rounding to powers of two keeps the set of distinct compiled
    programs tiny and stable across corpus-regeneration noise — in
    particular the hottest chunk lands on the same max_steps the cold
    (heuristic-sort) run compiles, so a wiped environment's second run
    compiles nothing new. The bound strictly exceeds the measured max
    (+`slack` before rounding), preserving the truncation-assert
    contract. A trailing partial chunk gets its own bound (bench.py's
    corpora divide evenly, but an external caller's need not — silently
    dropping tail pairs would break the truncation contract for them)."""
    n_chunks = -(-len(steps) // chunk)
    return [
        max(floor,
            1 << int(steps[i * chunk:(i + 1) * chunk].max() + slack - 1)
            .bit_length())
        for i in range(n_chunks)
    ]
