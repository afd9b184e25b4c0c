"""SIMD_ED semantics: batched kernel + filter app vs the stateful emulator.

The emulator (reference_impl.simd_ed_ref) is itself diffed against the
COMPILED SIMD_ED.cpp by tools/validate_vs_reference.py (0 mismatches on
1800 pairs across both modes). Here the hermetic suite asserts:

  * leap_align(semantics="simd_ed_lev"/"simd_ed_affine") equals a FRESH
    emulator per pair (the batched kernel deliberately does not reproduce
    the reference's cross-pair state leaks);
  * the fused SHD gate (use_shd_gate) matches the emulator's in-run gate;
  * apps.leap_filter.make_filter_step applies main.cpp's pair conventions
    (length = read length, ref strncpy'd) identically;
  * pinned quirks: affine pairs converging at e=0 report converge_ED ==
    1000000; the stateful emulator's levenshtein stale-flip can pass a
    pair that a fresh run fails.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from asm_tpu.config import AlignConfig, LeapMode
from asm_tpu.data.generator import generate_dataset
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.leap import leap_align
from asm_tpu.apps.leap_filter import make_filter_step
from asm_tpu.reference_impl.simd_ed_ref import SimdEdRef


def _fresh(read, ref, k, lev, shd):
    emu = SimdEdRef()
    if lev:
        emu.init_levenshtein(k, LeapMode.GLOBAL, shd)
    else:
        emu.init_affine(k, 3 * k, LeapMode.GLOBAL, 2, 3, 1, False)
    emu.load_pair(read, ref)
    emu.reset()
    emu.run()
    return bool(emu.check_pass()), int(emu.get_ed())


def _main_cpp_inputs(reads, refs, L):
    """main.cpp:137-196 conventions: length = read length; ref strncpy'd
    to it (zero-padded = code A when shorter, truncated when longer)."""
    rc, rl, fc, fl = map(jnp.asarray, encode_batch(reads, refs, L))
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    rl32 = rl.astype(jnp.int32)
    fc_eff = jnp.where((pos < rl32[:, None]) & (fc >= 4), 0, fc)
    return rc, rl32, fc_eff


@pytest.mark.parametrize("lev,shd,k,err,mr,seed", [
    (1, 1, 3, 0.05, 0.96, 41),   # main.cpp levenshtein default (gated)
    (1, 0, 3, 0.10, 0.96, 42),
    (1, 1, 5, 0.15, 0.50, 43),   # indel-heavy: exercises lane mirroring
    (0, 0, 3, 0.05, 0.96, 44),   # main.cpp affine default
    (0, 0, 4, 0.20, 0.50, 45),
])
def test_kernel_matches_fresh_simd_ed(lev, shd, k, err, mr, seed):
    reads, refs = generate_dataset(96, 100, err, mr, seed=seed)
    rc, rl32, fc_eff = _main_cpp_inputs(reads, refs, 128)
    if lev:
        cfg = AlignConfig(x=1, o=1, e=1, k=k, leap_af_threshold=k,
                          leap_mode=LeapMode.GLOBAL, max_len=128)
        out = leap_align(rc, rl32, fc_eff, rl32, cfg,
                         semantics="simd_ed_lev", use_shd_gate=bool(shd))
    else:
        cfg = AlignConfig(x=2, o=3, e=1, k=k, leap_af_threshold=3 * k,
                          leap_mode=LeapMode.GLOBAL, max_len=128)
        out = leap_align(rc, rl32, fc_eff, rl32, cfg,
                         semantics="simd_ed_affine")
    got_p = np.asarray(out["passed"])
    got_e = np.asarray(out["penalty"])
    for i, (a, b) in enumerate(zip(reads, refs)):
        assert (bool(got_p[i]), int(got_e[i])) == _fresh(a, b, k, lev,
                                                         bool(shd)), i


@pytest.mark.parametrize("lev", [1, 0])
def test_filter_step_matches_fresh_simd_ed(lev):
    k = 3
    reads, refs = generate_dataset(96, 100, 0.05, 0.96, seed=46)
    if lev:
        cfg = AlignConfig(x=1, o=1, e=1, k=k, leap_af_threshold=k,
                          leap_mode=LeapMode.GLOBAL, max_len=128)
    else:
        cfg = AlignConfig(x=2, o=3, e=1, k=k, leap_af_threshold=3 * k,
                          leap_mode=LeapMode.GLOBAL, max_len=128)
    step = make_filter_step(cfg, bool(lev), bool(lev))
    got = np.asarray(step(*map(jnp.asarray,
                               encode_batch(reads, refs, 128))))
    for i, (a, b) in enumerate(zip(reads, refs)):
        assert bool(got[i]) == _fresh(a, b, k, lev, bool(lev))[0], i


def test_affine_e0_reports_reset_converge_ed():
    """Identical strings converge at e=0, returning before any correction:
    get_ED reads reset_affine's converge_ED == 1000000 (SIMD_ED.cpp:485,
    509-513) even though the pair passes."""
    s = "ACGTACGTACGTACGT"
    cfg = AlignConfig(x=2, o=3, e=1, k=3, leap_af_threshold=9,
                      leap_mode=LeapMode.GLOBAL, max_len=128)
    rc, rl32, fc_eff = _main_cpp_inputs([s], [s], 128)
    out = leap_align(rc, rl32, fc_eff, rl32, cfg, semantics="simd_ed_affine")
    assert bool(np.asarray(out["passed"])[0])
    assert int(np.asarray(out["penalty"])[0]) == 1000000
    assert _fresh(s, s, 3, 0, False) == (True, 1000000)


def test_levenshtein_stale_flip_quirk():
    """run_levenshtein's GLOBAL correction runs on STALE final_ED /
    final_lane_idx when nothing converged (SIMD_ED.cpp:349-352): after a
    passing pair, a hopeless pair reports pass=true. The stateful
    emulator reproduces it; run_pair flags it as leaked."""
    emu = SimdEdRef()
    emu.init_levenshtein(3, LeapMode.GLOBAL, False)
    good = "ACGTACGTACGTACGTACGT"
    bad = "AAAAAAAAAAAAAAAAAAAA"
    bad_ref = "CCCCCCCCCCCCCCCCCCCC"
    first = emu.run_pair(good, good, want_cigar=False)
    assert first["passed"] and not first["leaked"]
    second = emu.run_pair(bad, bad_ref, want_cigar=False)
    assert second["passed"] and second["leaked"]  # the quirk
    assert not _fresh(bad, bad_ref, 3, 1, False)[0]  # fresh run fails


@pytest.mark.parametrize("lev,shd", [(1, 1), (1, 0), (0, 0)])
def test_simd_ed_gate_matches_fresh_simd_ed(lev, shd):
    """SIMD_ED semantics with and without the fused SHD gate, on a second
    corpus: per pair equal to a fresh emulator run with the same gate."""
    k = 3
    reads, refs = generate_dataset(96, 100, 0.05, 0.96, seed=66)
    rc, rl32, fc_eff = _main_cpp_inputs(reads, refs, 128)
    if lev:
        cfg = AlignConfig(x=1, o=1, e=1, k=k, leap_af_threshold=k,
                          leap_mode=LeapMode.GLOBAL, max_len=128)
        sem = "simd_ed_lev"
    else:
        cfg = AlignConfig(x=2, o=3, e=1, k=k, leap_af_threshold=3 * k,
                          leap_mode=LeapMode.GLOBAL, max_len=128)
        sem = "simd_ed_affine"
    out = leap_align(rc, rl32, fc_eff, rl32, cfg, semantics=sem,
                     use_shd_gate=bool(shd))
    got_p = np.asarray(out["passed"])
    got_e = np.asarray(out["penalty"])
    for i, (a, b) in enumerate(zip(reads, refs)):
        assert (bool(got_p[i]), int(got_e[i])) == _fresh(a, b, k, lev,
                                                         bool(shd)), i


def test_filter_L256_matches_fresh_simd_ed():
    """The filter CLI's actual config (max_len=256, gate fused): exercises
    the W=8 lane words and the error==0 BEG row's cleared bit 255
    (shd_ref.DEFAULT_OOB_ROW) at full register width."""
    k = 3
    reads, refs = generate_dataset(64, 100, 0.05, 0.96, seed=67)
    cfg = AlignConfig(x=1, o=1, e=1, k=k, leap_af_threshold=k,
                      leap_mode=LeapMode.GLOBAL, max_len=256)
    step = make_filter_step(cfg, True, True)
    got = np.asarray(step(*map(jnp.asarray,
                               encode_batch(reads, refs, 256))))
    for i, (a, b) in enumerate(zip(reads, refs)):
        assert bool(got[i]) == _fresh(a, b, k, 1, True)[0], i
