"""Mapper quality + throughput artifact at chromosome scale.

Generates a synthetic genome (default 50 Mbp — human-chromosome order),
samples reads at KNOWN origins with a real-profile error process
(SRR611076 rates: ~2.45% mismatch, ~0.05% insert, ~0.055% delete,
reference README.md:73-76), runs the full index -> pigeonhole seed ->
batched device rescore pipeline (asm_tpu.mapper), and reports:

  * recall: fraction of reads whose best placement is within TOL of the
    true origin (the quality measure the reference mapper demo implies,
    GASMA/mapper/main.cpp:43-99 — SeqAn3 hit + best-cost rescoring);
  * MAPQ sanity (mapq == 60 + cost, the main.cpp:96 quirk);
  * unmapped rate and cost distribution;
  * end-to-end reads/s plus the index build / candidates / rescore
    wall-time split.

Usage: python tools/mapper_eval.py [--genome-mbp 50] [--reads 20000]
       [--read-len 100] [--batch 8192] [--seed 7] [--platform cpu|gpu]
Prints one JSON line at the end, naming the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from asm_tpu.mapper.simulate import sample_reads  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=50.0)
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--max-errors", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tol", type=int, default=5)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"])
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from asm_tpu.runtime import describe, require_device, use_compile_cache

    use_compile_cache()
    device = require_device()
    print(describe(device), file=sys.stderr)

    from asm_tpu.mapper.core import MapperConfig, build_index, map_reads

    rng = np.random.default_rng(args.seed)
    n = int(args.genome_mbp * 1e6)
    t0 = time.perf_counter()
    genome = rng.integers(0, 4, size=n, dtype=np.int8)
    t_gen = time.perf_counter() - t0
    print(f"genome: {n/1e6:.0f} Mbp ({t_gen:.1f}s)", file=sys.stderr)

    t0 = time.perf_counter()
    idx = build_index(genome)
    t_index = time.perf_counter() - t0
    print(f"index build: {t_index:.1f}s "
          f"({n / t_index / 1e6:.2f} Mbp/s)", file=sys.stderr)

    t0 = time.perf_counter()
    reads, lens, origins, nerr = sample_reads(genome, args.reads,
                                              args.read_len, rng)
    print(f"read sampling: {time.perf_counter() - t0:.1f}s "
          f"(errors/read mean {nerr.mean():.2f}, "
          f"{(nerr <= args.max_errors).mean():.3f} within the pigeonhole "
          f"budget)", file=sys.stderr)

    mcfg = MapperConfig(max_errors=args.max_errors, batch=args.batch)
    # one warmup batch so the rescore kernel compile is not in the
    # measured region (compile is one-time; the mapper reuses it)
    map_reads(idx, genome, reads[:8], lens[:8], mcfg=mcfg)

    # two measured passes: the FIRST pays one-time device program load;
    # the SECOND is the steady state a production mapper runs in —
    # report both
    t_cold = t_map = None
    prof = {}
    for label in ("cold", "steady"):
        prof = {}
        t0 = time.perf_counter()
        best, sam = map_reads(idx, genome, reads, lens, mcfg=mcfg,
                              profile=prof)
        t = time.perf_counter() - t0
        if label == "cold":
            t_cold = t
        else:
            t_map = t
        staged = sum(v for k, v in prof.items() if k.endswith("_s"))
        print(f"[{label}] stage profile (s): " + "  ".join(
            f"{k[:-2]}={v:.2f}" for k, v in prof.items()
            if k.endswith("_s")) +
            f"  [stages {staged:.2f} / wall {t:.2f}]  "
            f"jobs={prof.get('n_jobs')} two_phase={prof.get('two_phase')}",
            file=sys.stderr)

    hit = sum(b is not None for b in best)
    ok = np.array([
        b is not None and abs(b["pos"] - int(o)) <= args.tol
        for b, o in zip(best, origins)
    ])
    mapq_ok = all(b is None or b["mapq"] == 60 + b["cost"] for b in best)
    costs = np.array([b["cost"] for b in best if b is not None])
    recall = float(ok.mean())
    # recall among reads the seeding scheme can guarantee a clean seed
    # for (<= max_errors injected) — what the reference's SeqAn3 search
    # with max_error_total is also limited to (mapper/main.cpp:67-69)
    elig = nerr <= args.max_errors
    recall_elig = float(ok[elig].mean())
    rps = args.reads / t_map
    print(
        f"mapped {hit}/{args.reads}  recall(|pos-origin|<={args.tol}) "
        f"{recall:.4f} (eligible {recall_elig:.4f})  "
        f"mapq_quirk_ok {mapq_ok}  "
        f"cost mean {costs.mean():.2f} p50 {np.median(costs):.0f} "
        f"max {costs.max()}  map wall {t_map:.1f}s (cold {t_cold:.1f}s) "
        f"= {rps:,.0f} reads/s",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "mapper_reads_per_sec",
        "value": round(rps, 1),
        "unit": "reads/s",
        "genome_mbp": args.genome_mbp,
        "reads": args.reads,
        "recall": round(recall, 4),
        "recall_eligible": round(recall_elig, 4),
        "unmapped": args.reads - hit,
        "index_build_s": round(t_index, 1),
        "cold_map_s": round(t_cold, 1),
        "cold_reads_per_sec": round(args.reads / t_cold, 1),
        "mapq_quirk_ok": mapq_ok,
        "device": device,
        "stage_profile_s": {k[:-2]: round(v, 3) for k, v in prof.items()
                            if k.endswith("_s")},
    }))


if __name__ == "__main__":
    main()
