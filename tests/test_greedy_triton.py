"""The greedy Pallas-Triton kernel against the scalar emulator.

On the CPU rig the kernel body runs in Pallas interpret mode; the same
body is what Triton compiles on the GPU (test_kernel_lowers_for_cuda
checks that lowering here, test_kernel_compiled_on_gpu runs it on the
card). The emulator (reference_impl.greedy_ref) mirrors hurdle_matrix.h;
its `max_steps` bound mirrors AlignConfig.max_steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asm_tpu.config import AlignConfig, AlignmentType
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import decode_string
from asm_tpu.kernels.greedy import greedy_align, pack_planes
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu.reference_impl.greedy_ref import greedy_ref


def _emulate(corpus, cfg):
    rc, rl, fc, fl = corpus
    out = []
    for i in range(rc.shape[0]):
        s1 = decode_string(rc[i], int(rl[i]))
        s2 = decode_string(fc[i], int(fl[i]))
        cost, cigar, trace = greedy_ref(
            s1, s2, k=cfg.k, x=cfg.x, o=cfg.o, e=cfg.e,
            alignment_type=cfg.alignment_type, max_len=cfg.max_len,
            return_trace=True, max_steps=cfg.max_steps)
        out.append((cost, cigar, len(trace)))
    return out


def _compare(corpus, cfg, max_cost_flips=0, max_cigar_flips=0):
    """Kernel == emulator per pair: cost, CIGAR and step count. On
    extreme-error corpora the heuristic's exact float ties can break the
    other way (greedy_ref docstring): a cost flip must then come with a
    rerouted walk (a different CIGAR), and the flips are counted."""
    got = greedy_align(*map(jnp.asarray, corpus), cfg)
    cost = np.asarray(got["cost"])
    steps = np.asarray(got["steps"])
    cigars = batch_greedy_cigars(got)
    cost_flips = cigar_flips = 0
    for i, (w_cost, w_cigar, w_steps) in enumerate(_emulate(corpus, cfg)):
        if cigars[i] != w_cigar:
            cigar_flips += 1
            cost_flips += int(cost[i] != w_cost)
            continue
        assert cost[i] == w_cost, f"pair {i}: same walk, different cost"
        assert steps[i] == w_steps, f"pair {i}"
    assert cost_flips <= max_cost_flips, cost_flips
    assert cigar_flips <= max_cigar_flips, cigar_flips


@pytest.mark.parametrize("atype",
                         [AlignmentType.GLOBAL, AlignmentType.SEMI_GLOBAL])
@pytest.mark.parametrize("err,mr,cost_flips,cigar_flips", [
    (0.05, 0.96, 0, 0),
    (0.2, 0.96, 0, 0),
    # indel-heavy: measured 2 cost / 3 CIGAR tie flips in both modes
    (0.4, 0.5, 2, 3),
])
def test_kernel_matches_emulator(err, mr, cost_flips, cigar_flips, atype):
    # SEMI_GLOBAL exercises the peeled first step's free lane switch
    cfg = AlignConfig(max_steps=24, alignment_type=atype)
    corpus = generate_dataset_arrays(48, 100, err, mr, seed=int(err * 100))
    _compare(corpus, cfg, max_cost_flips=cost_flips,
             max_cigar_flips=cigar_flips)


def test_kernel_other_penalties():
    cfg = AlignConfig(x=2, o=3, e=1, k=2, max_steps=24)
    _compare(generate_dataset_arrays(32, 80, 0.1, 0.8, seed=5), cfg)


@pytest.mark.parametrize("atype",
                         [AlignmentType.GLOBAL, AlignmentType.SEMI_GLOBAL])
@pytest.mark.parametrize("bound", [1, 2])
def test_kernel_tiny_steps_bound(bound, atype):
    # bound=1 runs ONLY the peeled first step (the while_loop body never
    # executes), bound=2 the peel plus one loop iteration; both truncate
    # exactly like the bounded emulator, final leap included
    cfg = AlignConfig(max_steps=bound, alignment_type=atype)
    _compare(generate_dataset_arrays(32, 100, 0.1, 0.9, seed=17), cfg)


def test_kernel_want_cigar_false():
    cfg = AlignConfig(max_steps=24)
    a = [jnp.asarray(v)
         for v in generate_dataset_arrays(16, 100, 0.1, seed=9)]
    full = greedy_align(*a, cfg)
    lean = greedy_align(*a, cfg, want_cigar=False)
    assert set(lean) == {"cost", "steps"}
    for key in ("cost", "steps"):
        np.testing.assert_array_equal(np.asarray(lean[key]),
                                      np.asarray(full[key]))


def test_kernel_batch_padding_invariant():
    """B=200 is no multiple of the kernel block: the padded pairs must not
    change any real pair's result, and each pair's result must not depend
    on the rest of its batch (blocks exit on their own pairs)."""
    cfg = AlignConfig(max_steps=24)
    corpus = generate_dataset_arrays(200, 100, 0.15, 0.8, seed=11)
    whole = greedy_align(*map(jnp.asarray, corpus), cfg)
    parts = [greedy_align(*(jnp.asarray(v[s]) for v in corpus), cfg)
             for s in (slice(0, 7), slice(7, 200))]
    for key in ("cost", "steps", "cigar_ops", "cigar_runs"):
        np.testing.assert_array_equal(
            np.asarray(whole[key]),
            np.concatenate([np.asarray(p[key]) for p in parts]))


def test_pack_planes_layout():
    """pack_planes carries exactly the kernel's plane order: row w bit p =
    code bit 0 of position 32w+p, row W+w the same for code bit 1, zero
    rows padding 2W to a power of two."""
    rng = np.random.default_rng(5)
    for B, L in [(3, 128), (37, 96), (5, 32)]:
        arr = rng.integers(0, 6, (B, L)).astype(np.int8)
        got = np.asarray(pack_planes(jnp.asarray(arr), L))
        W = L // 32
        rows = 1 << (2 * W - 1).bit_length()
        ref = np.zeros((rows, B), np.uint32)
        for i in range(B):
            for p in range(L):
                w, bit = divmod(p, 32)
                c = int(arr[i, p])
                ref[w, i] |= np.uint32((c & 1) << bit)
                ref[W + w, i] |= np.uint32(((c >> 1) & 1) << bit)
        np.testing.assert_array_equal(got, ref)


def test_kernel_rejects_unsupported_flip_threshold():
    cfg = AlignConfig(flip_threshold=2, max_steps=8)
    a = [jnp.asarray(v) for v in generate_dataset_arrays(8, 50, 0.1, seed=1)]
    with pytest.raises(NotImplementedError):
        greedy_align(*a, cfg)


def test_kernel_rejects_max_len_not_multiple_of_32():
    cfg = AlignConfig(max_len=100, max_steps=8)
    a = [jnp.asarray(v) for v in generate_dataset_arrays(
        8, 50, 0.1, seed=1, max_len=100)]
    with pytest.raises(ValueError, match="multiple of 32|% 32"):
        greedy_align(*a, cfg)


def test_kernel_variable_lengths_matches_emulator():
    cfg = AlignConfig(k=3, max_steps=24)
    corpus = generate_dataset_arrays(128, 100, 0.15, seed=44,
                                     length_range=(60, 120))
    _compare(corpus, cfg)


@pytest.mark.parametrize("want_cigar", [False, True])
def test_kernel_lowers_for_cuda(want_cigar):
    """The kernel lowers to Triton IR for CUDA (no unsupported primitive)
    without a GPU; the card's compiler itself runs in chip_smoke.py."""
    from jax import export

    cfg = AlignConfig(max_steps=32)
    code = jax.ShapeDtypeStruct((256, cfg.max_len), jnp.int8)
    length = jax.ShapeDtypeStruct((256,), jnp.int32)
    exp = export.export(
        jax.jit(functools.partial(greedy_align, cfg=cfg,
                                  want_cigar=want_cigar)),
        platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(code, length, code, length)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text and 'name = "greedy_align"' in text


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    """Compiled by Triton on the card: equal to the emulator at err 0.05."""
    cfg = AlignConfig(max_steps=32)
    corpus = generate_dataset_arrays(512, 100, 0.05, 0.96, seed=3)
    with jax.default_device(gpu):
        _compare(corpus, cfg)
