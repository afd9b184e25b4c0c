"""Multi-device / multi-host scale-out for the alignment kernels.

The reference is strictly single-threaded, single-process — its only
parallelism is bit-level SWAR inside one SSE/AVX2 register
(SURVEY.md §2.3; GASMA/benchmark/benchmark_utils.h:374-383 is a plain
sequential loop). The framework's scale-out story replaces that:

  * on one device: thousands of pairs batched (the kernels);
  * multi-chip: a 1-D `jax.sharding.Mesh` over all devices, read-pair
    batches sharded on the leading axis via `shard_map`, penalty tables
    replicated, accuracy/coverage/time counters reduced with `psum`
    (XLA hands it to NCCL between GPUs; the reference has no such
    layer — no point-to-point traffic is needed, the workload is
    embarrassingly parallel with scalar reductions);
  * multi-host: `jax.distributed.initialize` + the same mesh spanning all
    hosts; each host packs and feeds its own corpus shard.
"""

from asm_tpu.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_on_axis,
    batch_pspec,
    initialize_distributed,
)
from asm_tpu.parallel.runner import (
    make_sharded_pipeline,
    make_sharded_greedy,
    BatchStats,
)
from asm_tpu.parallel.schedule import (
    difficulty_proxy,
    difficulty_order,
    quantized_step_bounds,
    inverse_permutation,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "shard_on_axis",
    "batch_pspec",
    "initialize_distributed",
    "make_sharded_pipeline",
    "make_sharded_greedy",
    "BatchStats",
    "difficulty_proxy",
    "difficulty_order",
    "quantized_step_bounds",
    "inverse_permutation",
]
