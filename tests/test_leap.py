"""LEAP kernel conformance: batched kernel vs the scalar emulator
(asm_tpu.reference_impl.leap_ref, a mirror of LEAP_SIMD/LV_BAG.cpp)."""

import numpy as np
import jax.numpy as jnp
import pytest

from asm_tpu.config import AlignConfig, LeapMode
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.leap import leap_align
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu.data.generator import generate_dataset


def _run_batch(reads, refs, cfg):
    rc, rl, fc, fl = encode_batch(reads, refs, cfg.max_len)
    out = leap_align(
        jnp.asarray(rc), jnp.asarray(rl), jnp.asarray(fc), jnp.asarray(fl), cfg
    )
    return (
        np.asarray(out["passed"]),
        np.asarray(out["penalty"]),
        np.asarray(out["lane_shift"]),
    )


@pytest.mark.parametrize("err", [0.05, 0.10, 0.20])
def test_leap_matches_scalar_ref(err):
    cfg = AlignConfig(x=1, o=1, e=1, k=3, leap_af_threshold=200)
    reads, refs = generate_dataset(48, 100, err, 0.96, seed=int(err * 777))
    passed, pen, shift = _run_batch(reads, refs, cfg)
    for i in range(len(reads)):
        e_pass, e_ed, e_shift = leap_ref(
            reads[i], refs[i], k=3, af_threshold=200,
            ms_penalty=1, gap_open_penalty=1, gap_ext_penalty=1,
        )
        assert passed[i] == e_pass, f"pair {i}"
        assert pen[i] == e_ed, f"pair {i}"
        assert shift[i] == e_shift, f"pair {i}"


def test_leap_affine_penalties():
    cfg = AlignConfig(x=2, o=3, e=1, k=3, leap_af_threshold=60)
    reads, refs = generate_dataset(32, 80, 0.1, 0.7, seed=21)
    passed, pen, shift = _run_batch(reads, refs, cfg)
    for i in range(len(reads)):
        e_pass, e_ed, e_shift = leap_ref(
            reads[i], refs[i], k=3, af_threshold=60,
            ms_penalty=2, gap_open_penalty=3, gap_ext_penalty=1,
        )
        assert passed[i] == e_pass, f"pair {i}"
        assert pen[i] == e_ed, f"pair {i}"
        assert shift[i] == e_shift, f"pair {i}"


def test_leap_local_mode():
    cfg = AlignConfig(k=2, leap_mode=LeapMode.LOCAL, leap_af_threshold=50)
    reads, refs = generate_dataset(24, 60, 0.15, 0.9, seed=31)
    passed, pen, shift = _run_batch(reads, refs, cfg)
    for i in range(len(reads)):
        e_pass, e_ed, e_shift = leap_ref(
            reads[i], refs[i], k=2, af_threshold=50, mode=LeapMode.LOCAL,
        )
        assert passed[i] == e_pass, f"pair {i}"
        assert pen[i] == e_ed, f"pair {i}"
        assert shift[i] == e_shift, f"pair {i}"


def test_leap_semi_free_modes():
    """SEMI_FREE_BEGIN (free start lanes, converge-ED corrected like
    GLOBAL — LV_BAG.cpp:103,221) and SEMI_FREE_END (anchored start, free
    end — LV_BAG.cpp:236-240) against the emulator, which is itself
    pinned to the compiled LV in tools/validate_vs_reference.py."""
    for mode in (LeapMode.SEMI_FREE_BEGIN, LeapMode.SEMI_FREE_END):
        cfg = AlignConfig(k=3, leap_mode=mode, leap_af_threshold=200)
        reads, refs = generate_dataset(24, 80, 0.12, 0.9,
                                       seed=60 + int(mode))
        passed, pen, shift = _run_batch(reads, refs, cfg)
        for i in range(len(reads)):
            e_pass, e_ed, e_shift = leap_ref(
                reads[i], refs[i], k=3, af_threshold=200, mode=mode,
            )
            assert passed[i] == e_pass, f"{mode.name} pair {i}"
            assert pen[i] == e_ed, f"{mode.name} pair {i}"
            assert shift[i] == e_shift, f"{mode.name} pair {i}"


def test_leap_tight_threshold_fails_noisy_pairs():
    """With a tiny energy budget, high-error pairs must NOT pass."""
    cfg = AlignConfig(k=3, leap_af_threshold=2)
    reads, refs = generate_dataset(16, 100, 0.2, 0.96, seed=41)
    passed, pen, _ = _run_batch(reads, refs, cfg)
    for i in range(len(reads)):
        e_pass, e_ed, _ = leap_ref(reads[i], refs[i], k=3, af_threshold=2)
        assert passed[i] == e_pass
        assert pen[i] == e_ed
        if not e_pass:
            assert pen[i] == 3  # af + 1


def test_leap_unit_cost_close_to_levenshtein():
    """At unit costs LEAP's energy equals banded edit distance, which for
    within-band pairs equals the NW optimum (accuracy 99.8% at err=.05 per
    the reference README; on identical/simple pairs it is exact)."""
    cfg = AlignConfig(k=3)
    reads = ["ACGTACGTACGT", "AAAACCCCGGGG"]
    refs = ["ACGTACGTACGT", "AAAACCCCGGGT"]
    passed, pen, _ = _run_batch(reads, refs, cfg)
    for i in range(2):
        exp, _ = nw_ref(reads[i], refs[i], traceback=False)
        assert passed[i]
        assert pen[i] == exp
