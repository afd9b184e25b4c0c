"""Device mesh utilities for data-parallel alignment.

The alignment workload is embarrassingly parallel over read pairs, so the
canonical mesh is 1-D over every addressable device with the corpus sharded
on the batch axis. Penalty parameters are Python statics (compiled into the
kernels) and the per-pair scan tables are built on-device inside each shard,
so nothing needs replication traffic at all — the only collectives are
`psum` reductions of scalar statistics (see asm_tpu.parallel.runner).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = BATCH_AXIS) -> Mesh:
    """A 1-D mesh over the first `n_devices` devices (default: all).

    Multi-host note: `jax.devices()` is the GLOBAL device list, so the same
    call on every host yields one global mesh; sharding a global array over
    it makes XLA's collectives span every host automatically.
    """
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def batch_pspec(mesh: Mesh) -> P:
    """PartitionSpec sharding the leading (batch) axis over the mesh."""
    return P(mesh.axis_names[0])


def shard_batch(mesh: Mesh, *arrays: jax.Array) -> tuple[jax.Array, ...]:
    """Place arrays with their leading axis sharded over the mesh.

    Every array's batch dimension must be divisible by the mesh size —
    pad the corpus to a multiple first (e.g. np.concatenate a repeat of
    the leading rows, as the bench harness does for tail chunks).
    """
    spec = batch_pspec(mesh)
    out = []
    for a in arrays:
        if a.shape[0] % mesh.size != 0:
            raise ValueError(
                f"batch {a.shape[0]} not divisible by mesh size {mesh.size}"
            )
        sharding = NamedSharding(mesh, P(*([spec[0]] + [None] * (a.ndim - 1))))
        out.append(jax.device_put(a, sharding))
    return tuple(out)


def shard_on_axis(mesh: Mesh, array: jax.Array, axis_index: int) -> jax.Array:
    """Place one array with dimension `axis_index` sharded over the mesh
    (for non-leading batch axes, e.g. the position-major staged corpus
    uint32[L/4, B] where the batch is axis 1)."""
    if array.shape[axis_index] % mesh.size != 0:
        raise ValueError(
            f"dim {axis_index} of {array.shape} not divisible by mesh "
            f"size {mesh.size}"
        )
    dims = [None] * array.ndim
    dims[axis_index] = mesh.axis_names[0]
    return jax.device_put(array, NamedSharding(mesh, P(*dims)))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: `jax.distributed.initialize` wrapper.

    Pass the coordinator address, process count and id explicitly (nothing
    on a plain GPU host or CPU rig detects them). Safe to call when already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialized (or single-process backend) — fine.
        pass
