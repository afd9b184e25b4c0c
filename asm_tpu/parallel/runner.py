"""Sharded end-to-end alignment pipelines.

`make_sharded_pipeline(mesh, cfg)` compiles the framework's full evaluation
step — the batched equivalent of the reference's per-pair benchmark loop
(GASMA/benchmark/benchmark_utils.h:231-259: run NW + LEAP + Greedy, compare
penalties) — as ONE pjit'd program over a device mesh:

  per shard (local, no communication):
      NW oracle penalties, Greedy cost, LEAP penalty, SHD gate
  cross-shard (collectives):
      psum-reduced counters (pairs, greedy/leap agreement with the NW
      oracle, leap pass count, penalty sums)

Per-pair outputs stay sharded on the batch axis; only the scalar statistics
travel — the reference's `benchmark::print` accuracy numbers
(benchmark_utils.h:390-402) fall out of the psum'd counters.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

# check_vma=False: the kernels are mesh-agnostic batched functions (their
# internal scan carries start from replicated iota constants); the only
# collective is the explicit psum below.
shard_map = functools.partial(jax.shard_map, check_vma=False)

from asm_tpu.config import AlignConfig
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.nw import nw_penalty


@dataclasses.dataclass
class BatchStats:
    """psum-reduced corpus statistics (host-side view)."""

    pairs: int
    greedy_correct: int
    leap_correct: int
    leap_passed: int
    nw_penalty_sum: int
    greedy_cost_sum: int
    leap_penalty_sum: int

    @property
    def greedy_accuracy(self) -> float:
        return self.greedy_correct / max(self.pairs, 1)

    @property
    def leap_accuracy(self) -> float:
        return self.leap_correct / max(self.pairs, 1)


def _pipeline_shard(cfg: AlignConfig, axis, read_codes, read_len, ref_codes,
                    ref_len):
    """Per-device shard of the evaluation step (runs under shard_map)."""
    nw_pen = nw_penalty(
        read_codes, read_len, ref_codes, ref_len, x=cfg.x, o=cfg.o, e=cfg.e
    )
    g = greedy_align(read_codes, read_len, ref_codes, ref_len, cfg,
                     want_cigar=False)
    l = leap_align(read_codes, read_len, ref_codes, ref_len, cfg)

    local = jnp.stack(
        [
            jnp.int32(read_codes.shape[0]),
            jnp.sum(g["cost"] == nw_pen, dtype=jnp.int32),
            jnp.sum(l["penalty"] == nw_pen, dtype=jnp.int32),
            jnp.sum(l["passed"], dtype=jnp.int32),
            jnp.sum(nw_pen, dtype=jnp.int32),
            jnp.sum(g["cost"], dtype=jnp.int32),
            jnp.sum(l["penalty"], dtype=jnp.int32),
        ]
    )
    stats = jax.lax.psum(local, axis_name=axis)
    return nw_pen, g["cost"], l["penalty"], stats


def make_sharded_pipeline(mesh, cfg: AlignConfig):
    """jit'd (read_codes, read_len, ref_codes, ref_len) ->
    (nw_pen[B], greedy_cost[B], leap_pen[B], stats_vec[7]) over the mesh.

    Inputs must be sharded (or shardable) on the leading batch axis with
    B % mesh.size == 0. Use `unpack_stats` on the 7-vector.
    """
    axis = mesh.axis_names[0]
    b = P(axis)
    r = P()  # replicated stats
    fn = shard_map(
        functools.partial(_pipeline_shard, cfg, axis),
        mesh=mesh,
        in_specs=(b, b, b, b),
        out_specs=(b, b, b, r),
    )
    return jax.jit(fn)


def make_sharded_greedy(mesh, cfg: AlignConfig, want_cigar: bool = False):
    """jit'd sharded greedy-only step: returns the greedy result dict with
    every leaf sharded on the batch axis (the pure-throughput path used by
    the flagship benchmark). want_cigar=False returns cost and steps only.
    """
    b = P(mesh.axis_names[0])
    fn = shard_map(
        lambda rc, rl, fc, fl: greedy_align(rc, rl, fc, fl, cfg,
                                            want_cigar=want_cigar),
        mesh=mesh,
        in_specs=(b, b, b, b),
        out_specs=b,
    )
    return jax.jit(fn)


def unpack_stats(stats_vec) -> BatchStats:
    v = [int(x) for x in stats_vec]
    return BatchStats(*v)
