"""Headline benchmark: greedy hurdle-matrix alignment throughput.

Replicates the reference's flagship measurement — simulated ~100 bp
read/ref pairs at error rate 0.05, penalties x=1,o=1,e=1, band k=3
(GASMA/benchmark/benchmark.cpp:14-26) — and reports alignments/s against
the reference's published 0.85 s / 1M pairs = 1.176M aligns/s on one CPU
core (README.md:14, BASELINE.md).

The step is the greedy kernel over the whole corpus, sharded over every
device JAX sees. Corpus generation and upload are outside the timed
region, matching the reference's accounting (benchmark_utils.h:185-201
times only reset+run around the greedy kernel). Each rep ends with
`jax.block_until_ready`.

Settings (environment): BENCH_PAIRS (default 2^24), BENCH_ERR (0.05),
BENCH_REPS (5).

Prints the device line and the step's memory analysis on stderr, then
ONE JSON line on stdout:
  {"metric": "greedy_alignments_per_sec", "value": N, "unit": "aligns/s",
   "vs_baseline": N, "pairs": N, "err": E, "device": {...}}
A run without a GPU fails, except a rehearsal with JAX_PLATFORMS=cpu
set, whose line carries "value": null and the CPU seconds instead.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from asm_tpu.config import AlignConfig
from asm_tpu.native import generate_dataset_native
from asm_tpu.parallel import make_mesh, shard_batch
from asm_tpu.parallel.runner import make_sharded_greedy
from asm_tpu.runtime import describe, require_device, use_compile_cache

# reference: 1M pairs in 0.85 s single-core (README.md:14)
BASELINE_ALIGNS_PER_SEC = 1_000_000 / 0.85


def main():
    use_compile_cache()
    device = require_device()
    plat = device["platform"]

    def log(msg):
        print(f"[{plat}] {msg}", file=sys.stderr, flush=True)

    log(describe(device))
    # 2^24 pairs: int8 codes 4.3 GB, the kernel's 2-bit planes 1.1 GB —
    # one step that fits one 80 GB card with wide margin
    n_pairs = int(os.environ.get("BENCH_PAIRS", 1 << 24))
    err = float(os.environ.get("BENCH_ERR", 0.05))
    reps = int(os.environ.get("BENCH_REPS", 5))
    cfg = AlignConfig(x=1, o=1, e=1, k=3, max_len=128)

    mesh = make_mesh()
    n_pairs -= n_pairs % mesh.size
    t0 = time.perf_counter()
    corpus = generate_dataset_native(n_pairs, 100, err, mismatch_rate=0.96,
                                     seed=42, max_len=cfg.max_len)
    log(f"corpus: {n_pairs} pairs err={err} "
        f"({time.perf_counter() - t0:.1f}s)")

    greedy = make_sharded_greedy(mesh, cfg)

    @jax.jit
    def step(rc, rl, fc, fl):
        out = greedy(rc, rl, fc, fl)
        return out["cost"], jnp.sum(out["cost"])

    t0 = time.perf_counter()
    args = jax.block_until_ready(shard_batch(mesh, *corpus))
    log(f"upload: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    log(f"compile: {time.perf_counter() - t0:.1f}s")
    log(f"memory_analysis: {compiled.memory_analysis()}")
    jax.block_until_ready(compiled(*args))  # first run, untimed

    best = float("inf")
    checksum = None
    for r in range(reps):
        t0 = time.perf_counter()
        cost, total = jax.block_until_ready(compiled(*args))
        dt = time.perf_counter() - t0
        best = min(best, dt)
        checksum = int(total)
        log(f"rep {r}: {dt:.6f}s  {n_pairs / dt / 1e6:.2f}M aligns/s")
    log(f"total-cost checksum: {checksum}")
    if checksum is None or checksum <= 0:
        raise RuntimeError(f"implausible total cost {checksum}")

    line = {
        "metric": "greedy_alignments_per_sec",
        "unit": "aligns/s",
        "pairs": n_pairs,
        "err": err,
        "device": device,
    }
    if plat == "gpu":
        line["value"] = n_pairs / best
        line["vs_baseline"] = n_pairs / best / BASELINE_ALIGNS_PER_SEC
    else:
        line["value"] = None
        line["cpu_rehearsal_best_seconds"] = best
    print(json.dumps(line))


if __name__ == "__main__":
    main()
