"""Multi-device data parallelism on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from asm_tpu.config import AlignConfig
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.parallel import make_mesh, shard_batch, batch_pspec
from asm_tpu.parallel.runner import (
    make_sharded_pipeline,
    make_sharded_greedy,
    unpack_stats,
)


@pytest.fixture(scope="module")
def corpus():
    return generate_dataset_arrays(64, 80, 0.1, seed=3)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.size == 8  # conftest forces 8 virtual CPU devices


def test_shard_batch_places_on_mesh(corpus):
    mesh = make_mesh()
    rc, rl, fc, fl = shard_batch(mesh, *corpus)
    assert rc.sharding.is_equivalent_to(
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("data", None)
        ),
        rc.ndim,
    )
    with pytest.raises(ValueError):
        shard_batch(mesh, np.zeros((9, 4)))  # not divisible


def test_sharded_pipeline_matches_single_device(corpus):
    cfg = AlignConfig(k=3)
    mesh8 = make_mesh(8)
    mesh1 = make_mesh(1)
    args8 = shard_batch(mesh8, *corpus)
    args1 = shard_batch(mesh1, *corpus)
    nw8, g8, l8, s8 = make_sharded_pipeline(mesh8, cfg)(*args8)
    nw1, g1, l1, s1 = make_sharded_pipeline(mesh1, cfg)(*args1)
    np.testing.assert_array_equal(np.asarray(nw8), np.asarray(nw1))
    np.testing.assert_array_equal(np.asarray(g8), np.asarray(g1))
    np.testing.assert_array_equal(np.asarray(l8), np.asarray(l1))
    np.testing.assert_array_equal(np.asarray(s8), np.asarray(s1))
    stats = unpack_stats(np.asarray(s8))
    assert stats.pairs == 64
    assert 0 <= stats.greedy_correct <= 64
    assert stats.greedy_cost_sum >= stats.nw_penalty_sum


def test_sharded_greedy_matches_emulator(corpus):
    """bench.py's step — make_sharded_greedy (cost and steps only) under
    shard_map on the 8-device mesh — per pair equal to the emulator."""
    from asm_tpu.encoding import decode_string
    from asm_tpu.reference_impl.greedy_ref import greedy_ref

    cfg = AlignConfig(k=3, max_steps=24)
    mesh = make_mesh()
    out = make_sharded_greedy(mesh, cfg)(*shard_batch(mesh, *corpus))
    assert set(out) == {"cost", "steps"}
    rc, rl, fc, fl = corpus
    for i in range(rc.shape[0]):
        cost, _, trace = greedy_ref(
            decode_string(rc[i], int(rl[i])), decode_string(fc[i], int(fl[i])),
            k=3, max_steps=24, return_trace=True)
        assert int(np.asarray(out["cost"])[i]) == cost, i
        assert int(np.asarray(out["steps"])[i]) == len(trace), i


def test_sharded_greedy_cigar_matches_unsharded(corpus):
    """want_cigar=True under shard_map: every CIGAR slot equals the
    unsharded kernel's."""
    import jax.numpy as jnp
    from asm_tpu.kernels.greedy import greedy_align

    cfg = AlignConfig(k=3, max_steps=24)
    mesh = make_mesh()
    out = make_sharded_greedy(mesh, cfg, want_cigar=True)(
        *shard_batch(mesh, *corpus))
    ref = greedy_align(*map(jnp.asarray, corpus), cfg)
    for key in ("cost", "steps", "cigar_ops", "cigar_runs", "cigar_count"):
        np.testing.assert_array_equal(np.asarray(out[key]),
                                      np.asarray(ref[key]), err_msg=key)


def test_sharded_greedy_matches_plain(corpus):
    import functools
    import jax.numpy as jnp
    from asm_tpu.kernels.greedy import greedy_align

    cfg = AlignConfig(k=3)
    mesh = make_mesh()
    out_sharded = make_sharded_greedy(mesh, cfg, want_cigar=True)(
        *shard_batch(mesh, *corpus))
    out_plain = jax.jit(functools.partial(greedy_align, cfg=cfg))(
        *map(jnp.asarray, corpus)
    )
    np.testing.assert_array_equal(
        np.asarray(out_sharded["cost"]), np.asarray(out_plain["cost"])
    )
    np.testing.assert_array_equal(
        np.asarray(out_sharded["cigar_runs"]),
        np.asarray(out_plain["cigar_runs"]),
    )


def test_sharded_greedy_shards_not_a_block_multiple():
    """8 shards of 23 pairs: every shard pads to the kernel block on its
    own, and the padding changes no real pair."""
    import jax.numpy as jnp
    from asm_tpu.kernels.greedy import greedy_align

    corpus = generate_dataset_arrays(8 * 23, 90, 0.12, seed=21)
    cfg = AlignConfig(k=3, max_steps=24)
    mesh = make_mesh()
    out = make_sharded_greedy(mesh, cfg)(*shard_batch(mesh, *corpus))
    ref = greedy_align(*map(jnp.asarray, corpus), cfg, want_cigar=False)
    np.testing.assert_array_equal(np.asarray(out["cost"]),
                                  np.asarray(ref["cost"]))


def test_dryrun_multichip_8():
    """The driver entry's multi-device dry run: sharded == one device per
    pair on the 8-device CPU mesh."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_sharded_pipeline_stats_match_per_pair(corpus):
    """The psum'd statistics equal the same sums over the per-pair
    outputs."""
    cfg = AlignConfig(k=3)
    mesh = make_mesh()
    nw, g, l, s = (np.asarray(a) for a in make_sharded_pipeline(mesh, cfg)(
        *shard_batch(mesh, *corpus)))
    from asm_tpu.kernels.leap import leap_align
    import jax.numpy as jnp

    passed = np.asarray(leap_align(*map(jnp.asarray, corpus), cfg)["passed"])
    want = [len(nw), int((g == nw).sum()), int((l == nw).sum()),
            int(passed.sum()), int(nw.sum()), int(g.sum()), int(l.sum())]
    np.testing.assert_array_equal(s, want)
