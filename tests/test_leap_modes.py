"""LEAP (kernels/leap.py) against the scalar emulators, mode by mode.

leap_ref mirrors LV_BAG.cpp (the benchmark's kernel) and SimdEdRef
SIMD_ED.cpp (the filter's); both are pinned to the compiled reference by
tools/validate_vs_reference.py. Every LeapMode, unit and affine
penalties, both SIMD_ED semantics, and the LEAP CIGAR path
(want_history + leap_backtrack) are covered.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from asm_tpu.config import AlignConfig, LeapMode
from asm_tpu.data.generator import generate_dataset, generate_dataset_arrays
from asm_tpu.encoding import decode_string, encode_batch
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.simd_ed_ref import SimdEdRef

ALL_MODES = [LeapMode.LOCAL, LeapMode.GLOBAL,
             LeapMode.SEMI_FREE_BEGIN, LeapMode.SEMI_FREE_END]


def _strings(corpus):
    rc, rl, fc, fl = corpus
    return [(decode_string(rc[i], int(rl[i])), decode_string(fc[i], int(fl[i])))
            for i in range(rc.shape[0])]


def _compare(corpus, cfg):
    out = leap_align(*map(jnp.asarray, corpus), cfg)
    passed, pen, shift = (np.asarray(out[k])
                          for k in ("passed", "penalty", "lane_shift"))
    for i, (s1, s2) in enumerate(_strings(corpus)):
        want = leap_ref(s1, s2, k=cfg.k, af_threshold=cfg.leap_af_threshold,
                        ms_penalty=cfg.x, gap_open_penalty=cfg.o,
                        gap_ext_penalty=cfg.e, mode=cfg.leap_mode,
                        max_len=cfg.max_len)
        assert (bool(passed[i]), int(pen[i]), int(shift[i])) == want, i


@pytest.mark.parametrize("name,n,length,err,mr,seed,cfg", [
    ("unit_err05", 48, 100, 0.05, 0.96, 5, AlignConfig(leap_af_threshold=60)),
    ("unit_err20", 48, 100, 0.2, 0.96, 20, AlignConfig(leap_af_threshold=60)),
    ("affine", 32, 80, 0.1, 0.7, 5,
     AlignConfig(x=2, o=3, e=1, leap_af_threshold=60)),
    ("local", 24, 60, 0.15, 0.9, 7,
     AlignConfig(k=2, leap_mode=LeapMode.LOCAL, leap_af_threshold=40)),
    ("tight_threshold", 16, 100, 0.2, 0.96, 9,
     AlignConfig(leap_af_threshold=2)),
])
def test_leap_matches_emulator(name, n, length, err, mr, seed, cfg):
    _compare(generate_dataset_arrays(n, length, err, mr, seed=seed), cfg)


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("affine", [False, True])
def test_leap_every_mode(mode, affine):
    """Every LeapMode (LV_BAG.h:38 ED_modes), unit and affine penalties —
    SEMI_FREE_BEGIN/END included (their init rows / convergence
    arbitration differ from GLOBAL)."""
    if affine:
        cfg = AlignConfig(x=2, o=3, e=1, k=3, leap_af_threshold=40,
                          leap_mode=mode)
    else:
        cfg = AlignConfig(k=3, leap_af_threshold=24, leap_mode=mode)
    _compare(generate_dataset_arrays(32, 80, 0.15, 0.8,
                                     seed=21 + 2 * int(mode) + int(affine)),
             cfg)


@pytest.mark.parametrize("batch", [1, 7, 200])
def test_leap_batch_composition_invariant(batch):
    """A pair's result does not depend on the batch it is aligned in."""
    cfg = AlignConfig(leap_af_threshold=60)
    corpus = generate_dataset_arrays(200, 100, 0.15, 0.8, seed=11)
    whole = leap_align(*map(jnp.asarray, corpus), cfg)
    part = leap_align(*(jnp.asarray(v[:batch]) for v in corpus), cfg)
    for key in ("passed", "penalty", "lane_shift"):
        np.testing.assert_array_equal(np.asarray(part[key]),
                                      np.asarray(whole[key])[:batch])


def test_leap_variable_lengths_matches_emulator():
    cfg = AlignConfig(leap_af_threshold=40)
    _compare(generate_dataset_arrays(64, 100, 0.1, 0.9, seed=14,
                                     length_range=(40, 120)), cfg)


def test_leap_wide_band_matches_emulator():
    cfg = AlignConfig(k=5, leap_af_threshold=60)
    _compare(generate_dataset_arrays(48, 100, 0.15, 0.5, seed=19), cfg)


def _fresh_simd_ed(read, ref, mode, sem):
    emu = SimdEdRef()
    if sem == "simd_ed_lev":
        emu.init_levenshtein(3, mode, False)
    else:
        emu.init_affine(3, 30, mode, 2, 3, 1, False)
    emu.load_pair(read, ref)
    emu.reset()
    emu.run()
    return bool(emu.check_pass()), int(emu.get_ed())


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("sem", ["simd_ed_lev", "simd_ed_affine"])
def test_leap_simd_ed_every_mode(sem, mode):
    """SIMD_ED semantics across all four ED modes (SIMD_ED.cpp:349-352 mode
    corrections) against a fresh emulator, with the filter's pair
    convention (main.cpp:137-196: length = read length, ref strncpy'd)."""
    if sem == "simd_ed_lev":
        cfg = AlignConfig(x=1, o=1, e=1, k=3, leap_af_threshold=3,
                          leap_mode=mode)
    else:
        cfg = AlignConfig(x=2, o=3, e=1, k=3, leap_af_threshold=30,
                          leap_mode=mode)
    reads, refs = generate_dataset(24, 80, 0.1, 0.9, seed=31 + int(mode))
    rc, rl, fc, _ = map(jnp.asarray, encode_batch(reads, refs, 128))
    rl32 = rl.astype(jnp.int32)
    pos = jnp.arange(128, dtype=jnp.int32)[None, :]
    fc_eff = jnp.where((pos < rl32[:, None]) & (fc >= 4), 0, fc)
    out = leap_align(rc, rl32, fc_eff, rl32, cfg, semantics=sem)
    got = list(zip(np.asarray(out["passed"]), np.asarray(out["penalty"])))
    for i, (a, b) in enumerate(zip(reads, refs)):
        assert (bool(got[i][0]), int(got[i][1])) == _fresh_simd_ed(
            a, b, mode, sem), i


@pytest.mark.parametrize("err,mr,seed,cfg", [
    # the benchmark's unit-cost GLOBAL config
    (0.05, 0.96, 50,
     AlignConfig(x=1, o=1, e=1, k=3, leap_af_threshold=24)),
    # affine penalties: gap-open vs gap-extend chain replay
    (0.10, 0.96, 51,
     AlignConfig(x=2, o=3, e=1, k=3, leap_af_threshold=30)),
    # indel-heavy, wider band: long I/D chains + lane corrections
    (0.20, 0.50, 52,
     AlignConfig(x=2, o=3, e=1, k=4, leap_af_threshold=36)),
    # LOCAL mode: no lane-correction prefix
    (0.10, 0.96, 53,
     AlignConfig(k=3, leap_af_threshold=24, leap_mode=LeapMode.LOCAL)),
    # SEMI_FREE_BEGIN: free-begin init rows + lane-correction prefix
    (0.10, 0.80, 54,
     AlignConfig(x=2, o=3, e=1, k=3, leap_af_threshold=30,
                 leap_mode=LeapMode.SEMI_FREE_BEGIN)),
    # SEMI_FREE_END: last-converged-lane pick, no correction prefix
    (0.10, 0.80, 55,
     AlignConfig(k=3, leap_af_threshold=24,
                 leap_mode=LeapMode.SEMI_FREE_END)),
    # energies well above 48 under the benchmark's af_threshold=200
    (0.30, 0.96, 60,
     AlignConfig(x=2, o=3, e=1, k=4, leap_af_threshold=200)),
    # easy corpus at af 200
    (0.05, 0.96, 61, AlignConfig(k=3, leap_af_threshold=200)),
    (0.15, 0.90, 62, AlignConfig(k=3, leap_af_threshold=60)),
    (0.15, 0.90, 63, AlignConfig(k=3, leap_af_threshold=30)),
    (0.15, 0.90, 64, AlignConfig(k=3, leap_af_threshold=60, max_len=256)),
])
def test_leap_cigar_matches_emulator(err, mr, seed, cfg):
    """LEAP CIGARs: want_history + leap_backtrack. passed / penalty /
    lane shift equal the emulator's, the lane-correction prefix matches
    the final lane shift, and every edit list re-scores to its penalty
    (x per mismatch, o per opened gap chain, e per extension)."""
    reads, refs = generate_dataset(32, 100, err, mr, seed=seed)
    a = [jnp.asarray(v) for v in encode_batch(reads, refs, cfg.max_len)]
    h = leap_align(*a, cfg, want_history=True)
    passed, pen, shift = (np.asarray(h[k])
                          for k in ("passed", "penalty", "lane_shift"))
    checked = 0
    for i, r in enumerate(leap_backtrack_batch(h, cfg)):
        want = leap_ref(reads[i], refs[i], k=cfg.k,
                        af_threshold=cfg.leap_af_threshold, ms_penalty=cfg.x,
                        gap_open_penalty=cfg.o, gap_ext_penalty=cfg.e,
                        mode=cfg.leap_mode, max_len=cfg.max_len)
        assert (bool(passed[i]), int(pen[i]), int(shift[i])) == want, i
        if r is None:
            continue
        edits, cigar = r
        skip = (abs(int(shift[i])) if cfg.leap_mode in (
            LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN) else 0)
        for op, run, _ in edits[:skip]:
            assert run == 0 and op in ("I", "D"), (i, edits)
        score = sum(cfg.x if op == "M" else (cfg.o if is_open else cfg.e)
                    for op, _, is_open in edits[skip:-1])
        assert score == pen[i], (i, edits)
        assert cigar
        checked += 1
    assert checked >= 8
