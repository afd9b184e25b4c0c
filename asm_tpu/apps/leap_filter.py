"""LEAP batch edit-distance filter — mirror of LEAP_SIMD/main.cpp:35-300.

Reads pairs (two lines per pair: read, then ref) from stdin or a pair
file, runs the batched LEAP kernel with SIMD_ED semantics (the kernel
main.cpp drives — SIMD_ED.cpp:214-616), and reports pass/total counts
and timing:

  python -m asm_tpu.apps.leap_filter ERROR [USE_SHD] [USE_LEVENSHTEIN] \
      [--file pairs.seq]

Args mirror the reference CLI (main.cpp:55-69): ERROR is the edit
threshold; USE_SHD 1/0 (default per-mode: on for levenshtein, off for
affine, main.cpp:90-98); USE_LEVENSHTEIN 1 for init_levenshtein(error,
ED_GLOBAL) (default), 0 for the affine default init_affine(error, 3e,
ED_GLOBAL, 2, 3, 1) (main.cpp:97).

Conformance anchor: asm_tpu.reference_impl.simd_ed_ref (itself diffed
against the compiled SIMD_ED.cpp by tools/validate_vs_reference.py).
Per-pair conventions mirror main.cpp:137-196: the pair length is the
READ length; the ref is strncpy'd to it (zero-padded = 'A' when
shorter, truncated when longer). The SHD gate runs INSIDE the same
jitted program as the wavefront (one dispatch per batch), like the
reference gates inside run() (SIMD_ED.cpp:270). Documented deviations:
per-pair state is fresh (the reference object leaks DP tables and
final_* scalars across pairs — simd_ed_ref docstring), and the affine
gate, undefined behavior in the reference, is replaced by the
levenshtein gate at the same threshold when explicitly requested.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from asm_tpu.config import AlignConfig, LeapMode
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.shd import shd_gate_masks
from asm_tpu.ops.hurdles import build_leap_lanes
from asm_tpu.encoding import encode_batch

BATCH = 1 << 16


def make_filter_step(cfg: AlignConfig, use_levenshtein: bool, use_shd: bool):
    """One jitted program: main.cpp pair conventions + optional fused SHD
    gate + the SIMD_ED wavefront. Returns passed bool[B]."""
    semantics = "simd_ed_lev" if use_levenshtein else "simd_ed_affine"
    align = functools.partial(leap_align, cfg=cfg, semantics=semantics)

    @jax.jit
    def step(rc, rl, fc, fl):
        pos = jnp.arange(cfg.max_len, dtype=jnp.int32)[None, :]
        rl32 = rl.astype(jnp.int32)
        # strncpy(B, ref, read_len): zero-pad (code A) / truncate to rl
        fc_eff = jnp.where((pos < rl32[:, None]) & (fc >= 4), 0, fc)
        if use_levenshtein:
            out = align(rc, rl32, fc_eff, rl32, use_shd_gate=use_shd)
            return out["passed"]
        out = align(rc, rl32, fc_eff, rl32)
        passed = out["passed"]
        if use_shd:  # sane stand-in for the reference's UB affine gate
            rc0 = jnp.where(rc < 4, rc, 0)
            fc0 = jnp.where(fc_eff < 4, fc_eff, 0)
            gate = shd_gate_masks(
                build_leap_lanes(rc0, fc0, cfg.k)[:, 1:-1, :],
                jnp.minimum(rl32, cfg.max_len), cfg.k,
            )
            passed = passed & gate
        return passed

    return step


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("error", type=int)
    p.add_argument("use_shd", type=int, nargs="?", default=-1)
    p.add_argument("use_levenshtein", type=int, nargs="?", default=1)
    p.add_argument("--file", type=str, default=None)
    args = p.parse_args(argv)

    if args.use_levenshtein:
        # init_levenshtein(error, ED_GLOBAL, shd): band == threshold
        cfg = AlignConfig(
            x=1, o=1, e=1, k=args.error, leap_af_threshold=args.error,
            leap_mode=LeapMode.GLOBAL, max_len=256,
        )
    else:  # affine default: init_affine(error, error*3, ED_GLOBAL, 2, 3, 1)
        cfg = AlignConfig(
            x=2, o=3, e=1, k=args.error,
            leap_af_threshold=args.error * 3,
            leap_mode=LeapMode.GLOBAL, max_len=256,
        )
    # per-mode default when -1: SHD on for levenshtein, off for affine
    # (LEAP_SIMD/main.cpp:92-97)
    if args.use_shd == -1:
        use_shd = bool(args.use_levenshtein)
    else:
        use_shd = args.use_shd == 1

    step = make_filter_step(cfg, bool(args.use_levenshtein), use_shd)

    src = open(args.file) if args.file else sys.stdin
    total = passed = 0
    align_time = 0.0
    compiled = False

    def run_batch(rc, rl, fc, fl):
        out = step(jnp.asarray(rc), jnp.asarray(rl), jnp.asarray(fc),
                   jnp.asarray(fl))
        return np.asarray(out)

    while True:
        reads, refs = [], []
        for _ in range(BATCH):
            l1 = src.readline()
            if not l1:
                break
            l2 = src.readline()
            if not l2:
                break
            reads.append(l1.strip())
            refs.append(l2.strip())
        if not reads:
            break
        n = len(reads)
        # pad to the fixed BATCH shape: one compile for every batch,
        # mirroring the reference timing only the align loop (main.cpp:144)
        reads += [reads[0]] * (BATCH - n)
        refs += [refs[0]] * (BATCH - n)
        rc, rl, fc, fl = encode_batch(reads, refs, cfg.max_len)
        if not compiled:
            run_batch(rc, rl, fc, fl)  # compile outside the timed region
            compiled = True
        t0 = time.perf_counter()
        ok = run_batch(rc, rl, fc, fl)
        align_time += time.perf_counter() - t0
        passed += int(ok[:n].sum())
        total += n
    if args.file:
        src.close()

    # report format cf. LEAP_SIMD/main.cpp:276-278
    print(f"passNum: {passed}")
    print(f"totalNum: {total}")
    print(f"align time: {align_time:.3f} s")


if __name__ == "__main__":
    main()
