"""Three-way benchmark harness: NW oracle vs LEAP vs Greedy.

Mirrors the reference's `benchmark` class (GASMA/benchmark/
benchmark_utils.h:28-417) as batched device pipelines:

  * the 1M-iteration per-pair loop (:373-385) -> chunked batched kernel
    launches (the chunk size bounds per-launch working memory and fixes
    one compiled shape; the encoded corpus itself is staged on device
    up-front so the timed region measures only kernel execution);
  * per-algorithm `times()` accounting (:84-89) -> wall-clock around each
    chunked kernel pass, ended by `jax.block_until_ready`;
  * accuracy = penalty equals the NW optimum (:249-255);
  * coverage = greedy CIGAR covers the NW CIGAR's long consecutive
    matches with thresholds (1, 3) (:256-258, benchmark_coverage.h) —
    device-side match masks with a positional certificate, and the exact
    host check for the pairs the certificate leaves open.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from asm_tpu.config import AlignConfig
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.nw import nw_align, nw_penalty
from asm_tpu.metrics.coverage import check_coverage
from asm_tpu.ops.cigar import batch_greedy_cigars, batch_nw_cigars
from asm_tpu.encoding import decode_string


@dataclasses.dataclass
class BenchmarkResult:
    """Everything benchmark::print reports (benchmark_utils.h:390-402)."""

    total: int
    nw_time: float
    leap_time: float
    greedy_time: float
    nw_accuracy: float  # 1.0 by construction (NW is the oracle)
    leap_accuracy: float
    greedy_accuracy: float
    greedy_coverage: float
    coverage_checked: int
    # platform the times were taken on (jax.devices()[0].platform)
    platform: str = ""
    # derived throughputs (alignments / second)
    nw_aligns_per_sec: float = 0.0
    leap_aligns_per_sec: float = 0.0
    greedy_aligns_per_sec: float = 0.0


def run_benchmark(
    read_codes: np.ndarray,
    read_len: np.ndarray,
    ref_codes: np.ndarray,
    ref_len: np.ndarray,
    cfg: AlignConfig | None = None,
    chunk: int = 1 << 17,
    coverage_sample: int | None = None,
    want_coverage: bool = True,
    progress=None,
) -> BenchmarkResult:
    """Run the three-way benchmark over an encoded corpus.

    Args mirror the kernels' batch layout (int8 codes + int32 lengths).
    `chunk` bounds per-launch batch size; `coverage_sample=None` (the
    default) checks coverage on the FULL corpus like the reference
    (device masks + host fallback); an int caps the checked prefix; 0 or
    want_coverage=False disables it.
    """
    cfg = cfg or AlignConfig()
    B = read_codes.shape[0]
    chunk = min(chunk, B)

    slices = [slice(i, min(i + chunk, B)) for i in range(0, B, chunk)]

    def chunk_args(sl):
        # pad the tail chunk to the full chunk size (one compile for all)
        n = sl.stop - sl.start
        if n == chunk:
            return (read_codes[sl], read_len[sl], ref_codes[sl], ref_len[sl])
        pad = chunk - n
        return (
            np.concatenate([read_codes[sl], read_codes[:pad]]),
            np.concatenate([read_len[sl], read_len[:pad]]),
            np.concatenate([ref_codes[sl], ref_codes[:pad]]),
            np.concatenate([ref_len[sl], ref_len[:pad]]),
        )

    # staging is outside the timed region (benchmark_utils.h:185-201)
    staged = jax.block_until_ready(
        [tuple(map(jax.device_put, chunk_args(sl))) for sl in slices])
    sizes = [sl.stop - sl.start for sl in slices]

    def timed_pass(fn):
        # compile + first run on one chunk, untimed (the reference times
        # only the algorithm loop)
        jax.block_until_ready(fn(*staged[0], cfg=cfg))
        t0 = time.perf_counter()
        outs = jax.block_until_ready([fn(*args, cfg=cfg) for args in staged])
        dt = time.perf_counter() - t0
        return dt, np.concatenate(
            [np.asarray(o)[:n] for o, n in zip(outs, sizes)])

    nw_time, nw_pen = timed_pass(nw_step)
    greedy_time, g_cost = timed_pass(greedy_step)
    leap_time, l_pen = timed_pass(leap_step)

    leap_acc = float((l_pen == nw_pen).mean())
    greedy_acc = float((g_cost == nw_pen).mean())

    coverage = 0.0
    checked = 0
    if want_coverage and (coverage_sample is None or coverage_sample > 0):
        # Full-corpus coverage (the reference checks every pair,
        # benchmark_utils.h:256-258): device-side read-position LCM masks
        # + positional-subset certificate; only pairs failing the
        # certificate take the exact host/native character check
        # (metrics.coverage_device docstring).
        from asm_tpu.native import coverage_batch_native, load_native

        native_ok = load_native() is not None
        checked = B if coverage_sample is None else min(coverage_sample, B)
        align_chunk = min(chunk, COVERAGE_CHUNK, checked)
        covered = 0
        for i in range(0, checked, align_chunk):
            j = min(i + align_chunk, checked)
            rc, rl = read_codes[i:j], read_len[i:j]
            fc, fl = ref_codes[i:j], ref_len[i:j]
            if j - i < align_chunk:  # pad tail to the compiled shape
                pad = align_chunk - (j - i)
                rc = np.concatenate([rc, read_codes[:pad]])
                rl = np.concatenate([rl, read_len[:pad]])
                fc = np.concatenate([fc, ref_codes[:pad]])
                fl = np.concatenate([fl, ref_len[:pad]])
            cert, nw_ops, g_ops, g_runs = coverage_step(
                jnp.asarray(rc), jnp.asarray(rl), jnp.asarray(fc),
                jnp.asarray(fl), cfg=cfg,
            )
            cert = np.asarray(cert)[: j - i]
            covered += int(cert.sum())
            rest = np.nonzero(~cert)[0]
            if rest.size:
                # exact character-based covers() for the uncertified few
                nw_ops = np.asarray(nw_ops)[rest]
                g_ops = np.asarray(g_ops)[rest]
                g_runs = np.asarray(g_runs)[rest]
                if native_ok:
                    covered += int(coverage_batch_native(
                        rc[rest], rl[rest], g_ops, g_runs, nw_ops, 1, 3
                    ).sum())
                else:
                    nw_cigars = batch_nw_cigars(nw_ops)
                    g_cigars = batch_greedy_cigars(
                        {"cigar_ops": g_ops, "cigar_runs": g_runs}
                    )
                    for bi, b in enumerate(rest):
                        s1 = decode_string(rc[b], int(rl[b]))
                        s2 = decode_string(fc[b], int(fl[b]))
                        covered += check_coverage(
                            s1, s2, g_cigars[bi], nw_cigars[bi], 1, 3
                        )
            if progress:
                progress(f"coverage {j}/{checked}")
        coverage = covered / max(checked, 1)

    return BenchmarkResult(
        total=B,
        nw_time=nw_time,
        leap_time=leap_time,
        greedy_time=greedy_time,
        nw_accuracy=1.0,
        leap_accuracy=leap_acc,
        greedy_accuracy=greedy_acc,
        greedy_coverage=coverage,
        coverage_checked=checked,
        platform=jax.devices()[0].platform,
        nw_aligns_per_sec=B / nw_time if nw_time else 0.0,
        leap_aligns_per_sec=B / leap_time if leap_time else 0.0,
        greedy_aligns_per_sec=B / greedy_time if greedy_time else 0.0,
    )


# The harness's device programs, one jitted function each, so that a
# caller (chip_smoke.py) can lower and compile exactly what the harness
# runs. Each takes one chunk (int8 codes + int32 lengths).
@functools.partial(jax.jit, static_argnames=("cfg",))
def nw_step(rc, rl, fc, fl, cfg: AlignConfig):
    """NW oracle penalties int32[B]."""
    return nw_penalty(rc, rl, fc, fl, x=cfg.x, o=cfg.o, e=cfg.e)


@functools.partial(jax.jit, static_argnames=("cfg",))
def greedy_step(rc, rl, fc, fl, cfg: AlignConfig):
    """Greedy costs int32[B] (no CIGAR records)."""
    return greedy_align(rc, rl, fc, fl, cfg, want_cigar=False)["cost"]


@functools.partial(jax.jit, static_argnames=("cfg",))
def leap_step(rc, rl, fc, fl, cfg: AlignConfig):
    """LEAP penalties int32[B] (af_threshold + 1 where not passed)."""
    return leap_align(rc, rl, fc, fl, cfg)["penalty"]


# pairs per coverage launch: bounds the NW traceback's pointer tables
COVERAGE_CHUNK = 1 << 13


@functools.partial(jax.jit, static_argnames=("cfg",))
def coverage_step(rc, rl, fc, fl, cfg: AlignConfig):
    """One chunk of the coverage check: NW traceback with its match mask,
    greedy CIGARs, and the positional certificate (metrics.coverage_device).
    Returns (certified bool[B], nw_ops, greedy cigar_ops, cigar_runs)."""
    from asm_tpu.metrics.coverage_device import (
        greedy_match_mask,
        positional_covered,
    )

    with jax.named_scope("coverage"):
        _, nw_ops, nw_mask = nw_align(rc, rl, fc, fl, x=cfg.x, o=cfg.o,
                                      e=cfg.e, match_mask_threshold=3)
        g = greedy_align(rc, rl, fc, fl, cfg)
        g_mask = greedy_match_mask(g["cigar_ops"], g["cigar_runs"],
                                   rc.shape[1], 1)
        cert = positional_covered(g_mask, nw_mask)
    return cert, nw_ops, g["cigar_ops"], g["cigar_runs"]


def format_report(r: BenchmarkResult) -> str:
    """The reference's report block (benchmark_utils.h:390-402), plus
    throughput lines; every time names the platform it was taken on."""
    on = f" on {r.platform}"
    lines = [
        "===================== Benchmark Results =====================",
        f"Total number of alignments: {r.total}",
        f"[Time{on}]",
        f"=> Needleman-Wunsch | {r.nw_time:.3f} s"
        f"  ({r.nw_aligns_per_sec / 1e6:.3f}M aligns/s{on})",
        f"=> LEAP             | {r.leap_time:.3f} s"
        f"  ({r.leap_aligns_per_sec / 1e6:.3f}M aligns/s{on})",
        f"=> Greedy           | {r.greedy_time:.3f} s"
        f"  ({r.greedy_aligns_per_sec / 1e6:.3f}M aligns/s{on})",
        "[Accuracy] (percentage of alignments matching optimal penalty)",
        f"=> Needleman-Wunsch | {r.nw_accuracy * 100:.3f} %",
        f"=> LEAP             | {r.leap_accuracy * 100:.3f} %",
        f"=> Greedy           | {r.greedy_accuracy * 100:.3f} %",
        "[Coverage] (percentage of alignments covering all long consecutive matches)",
        f"=> Greedy           | {r.greedy_coverage * 100:.3f} %"
        f"  (checked on {r.coverage_checked} pairs)",
    ]
    return "\n".join(lines)
