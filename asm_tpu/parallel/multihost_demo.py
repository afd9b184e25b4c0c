"""Multi-host demonstration worker: a REAL ≥2-process `jax.distributed`
run of the sharded evaluation pipeline on CPU devices.

The reference is strictly single-process (SURVEY §2.3); the framework's
multi-host story is `initialize_distributed` + a global 1-D mesh +
psum-reduced statistics (asm_tpu.parallel.runner). This module makes that
story executable on one machine: each process hosts N virtual CPU
devices (XLA_FLAGS=--xla_force_host_platform_device_count=N), joins the
coordinator, builds the GLOBAL mesh over all processes' devices, feeds its
process-local corpus shard via jax.make_array_from_process_local_data, and
runs make_sharded_pipeline — whose psum rides the distributed backend
exactly as it would across hosts.

Run one process per shard (tests/test_multihost.py drives two):

  python -m asm_tpu.parallel.multihost_demo \
      --process-id 0 --num-processes 2 --port 9876 --out /tmp/stats0.json
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--reps", type=int, default=0,
                    help="after the compile run, re-execute the pipeline "
                         "this many times and record per-rep walls")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from asm_tpu.parallel import initialize_distributed

    initialize_distributed(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes, (
        jax.process_count(), args.num_processes
    )

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from asm_tpu.config import AlignConfig
    from asm_tpu.data.generator import generate_dataset_arrays
    from asm_tpu.parallel import make_mesh
    from asm_tpu.parallel.runner import make_sharded_pipeline, unpack_stats

    mesh = make_mesh()  # GLOBAL: all processes' devices
    n_dev = mesh.size
    B = args.pairs
    assert B % n_dev == 0

    # every process generates the same seeded corpus and keeps only its
    # own contiguous shard (a real ingest pipeline would read its own
    # file shard — SURVEY §7 "each host packs its own shard")
    rc, rl, fc, fl = generate_dataset_arrays(B, 100, 0.10, 0.96,
                                             seed=args.seed)
    lo = args.process_id * B // args.num_processes
    hi = (args.process_id + 1) * B // args.num_processes

    def globalize(a):
        sharding = NamedSharding(
            mesh, P(*([mesh.axis_names[0]] + [None] * (a.ndim - 1)))
        )
        return jax.make_array_from_process_local_data(sharding, a[lo:hi])

    cfg = AlignConfig(x=1, o=1, e=1, k=3)
    pipeline = make_sharded_pipeline(mesh, cfg)
    g_in = (globalize(rc), globalize(rl), globalize(fc), globalize(fl))
    nw_pen, g_cost, l_pen, stats_vec = pipeline(*g_in)
    stats = unpack_stats(np.asarray(stats_vec))

    rep_walls = []
    if args.reps:
        import time

        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = pipeline(*g_in)[-1]
            np.asarray(out)  # forces the psum'd stats to host
            rep_walls.append(time.perf_counter() - t0)

    with open(args.out, "w") as f:
        json.dump(
            dict(
                process_id=args.process_id,
                process_count=jax.process_count(),
                local_devices=len(jax.local_devices()),
                global_devices=n_dev,
                stats=[int(v) for v in np.asarray(stats_vec)],
                greedy_accuracy=stats.greedy_accuracy,
                leap_accuracy=stats.leap_accuracy,
                pairs_global=B,
                rep_seconds=rep_walls,
            ),
            f,
        )
    print(f"proc {args.process_id}: mesh {n_dev} devices over "
          f"{jax.process_count()} processes; stats {list(np.asarray(stats_vec))}")


if __name__ == "__main__":
    main()
