"""Variable-length corpora end-to-end (generator option + all kernels).

The reference's real data has variable read lengths (its MASK_END mask
machinery exists for exactly that, LEAP_SIMD/mask.cpp); here the
generator draws per-pair lengths and every kernel handles them via the
closed-form length masks. Asserted: generator envelope invariants, exact
greedy cost-only == CIGAR path (int16 records incl. the reconstructed
final-leap lane delta, which spans the widest on length-skewed pairs),
and scalar-oracle agreement.
"""

import numpy as np
import jax.numpy as jnp

from asm_tpu.config import AlignConfig
from asm_tpu.data.generator import (
    generate_dataset_arrays,
    generate_real_profile_arrays,
)
from asm_tpu.encoding import decode_string
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.kernels.nw import nw_penalty
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.kernels.leap import leap_align


def test_generator_length_range_envelope():
    rc, rl, fc, fl = generate_dataset_arrays(
        500, 100, 0.10, seed=9, length_range=(40, 120)
    )
    assert rl.min() >= 40 and rl.max() <= 120 and len(set(rl)) > 20
    # sentinels exactly past each true length
    pos = np.arange(rc.shape[1])[None, :]
    assert ((rc >= 4) == (pos >= rl[:, None])).all()
    assert ((fc >= 4) == (pos >= fl[:, None])).all()
    # fixed-length path unchanged byte-for-byte (cached-corpus contract)
    a = generate_dataset_arrays(50, 100, 0.10, seed=3)
    b = generate_dataset_arrays(50, 100, 0.10, seed=3, length_range=None)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_real_profile_length_range():
    rc, rl, fc, fl = generate_real_profile_arrays(
        300, seed=4, length_range=(60, 128)
    )
    assert rl.min() >= 60 and rl.max() <= 128 and len(set(rl)) > 10
    # profile indels are rare: ref lengths track read lengths closely
    assert (np.abs(fl - rl) <= 4).all()


def test_kernels_on_variable_lengths():
    rc, rl, fc, fl = generate_dataset_arrays(
        192, 100, 0.08, seed=5, length_range=(60, 120)
    )
    a = list(map(jnp.asarray, (rc, rl, fc, fl)))
    pen = np.asarray(nw_penalty(*a))
    cfg = AlignConfig(k=3)
    g = greedy_align(*a, cfg)
    g40 = greedy_align(*a, AlignConfig(k=3, max_steps=40))
    np.testing.assert_array_equal(np.asarray(g["cost"]),
                                  np.asarray(g40["cost"]))
    assert batch_greedy_cigars(g) == batch_greedy_cigars(g40)
    lout = leap_align(*a, cfg)
    lp = np.asarray(lout["penalty"])
    gc = np.asarray(g["cost"])
    for i in range(48):
        s1 = decode_string(rc[i], int(rl[i]))
        s2 = decode_string(fc[i], int(fl[i]))
        assert greedy_ref(s1, s2, k=3)[0] == gc[i], i
        _, led, _ = leap_ref(s1, s2, k=3,
                             af_threshold=cfg.leap_af_threshold)
        assert led == lp[i], i
        if i < 12:
            assert nw_ref(s1, s2, traceback=False)[0] == pen[i], i
