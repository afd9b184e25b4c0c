"""Long-sequence support: max_len is a config, not a compile-time cap.

The reference hard-caps reads at 128 chars (MAX_LENGTH, GASMA/utils.h:24,
truncation hurdle_matrix.h:487-488) or 256 (_MAX_LENGTH_, LV_BAG.h:18).
Here every kernel takes max_len as configuration (any multiple of 32);
these tests prove conformance holds at 256 and 512 — the "long-sequence
story" obligation of SURVEY.md §2.3."""

import numpy as np
import jax.numpy as jnp
import pytest

from asm_tpu.config import AlignConfig
from asm_tpu.data.generator import generate_dataset
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.nw import nw_penalty
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.nw_ref import nw_ref


@pytest.mark.parametrize("length,max_len", [(250, 256), (500, 512)])
def test_greedy_long_reads(length, max_len):
    cfg = AlignConfig(k=3, max_len=max_len, max_steps=64)
    reads, refs = generate_dataset(12, length, 0.05, 0.96, seed=length)
    rc, rl, fc, fl = encode_batch(reads, refs, max_len)
    a = [jnp.asarray(v) for v in (rc, rl, fc, fl)]
    out = greedy_align(*a, cfg)
    cost = np.asarray(out["cost"])
    for i in range(len(reads)):
        exp, _ = greedy_ref(reads[i], refs[i], k=3, max_len=max_len)
        assert cost[i] == exp, i
    # the cost-only variant agrees at the longer word count (W = L/32)
    lean = greedy_align(*a, cfg, want_cigar=False)
    np.testing.assert_array_equal(np.asarray(lean["cost"]), cost)


def test_leap_long_reads():
    cfg = AlignConfig(k=3, max_len=256, leap_af_threshold=100)
    reads, refs = generate_dataset(12, 250, 0.05, 0.96, seed=9)
    rc, rl, fc, fl = encode_batch(reads, refs, 256)
    a = [jnp.asarray(v) for v in (rc, rl, fc, fl)]
    out = leap_align(*a, cfg)
    pen = np.asarray(out["penalty"])
    for i in range(len(reads)):
        _, e_ed, _ = leap_ref(reads[i], refs[i], k=3, af_threshold=100,
                              max_len=256)
        assert pen[i] == e_ed, i


def test_nw_long_reads():
    reads, refs = generate_dataset(8, 250, 0.1, 0.9, seed=4)
    rc, rl, fc, fl = encode_batch(reads, refs, 256)
    pen = np.asarray(nw_penalty(
        jnp.asarray(rc), jnp.asarray(rl), jnp.asarray(fc), jnp.asarray(fl)
    ))
    for i in range(len(reads)):
        exp, _ = nw_ref(reads[i], refs[i], traceback=False)
        assert pen[i] == exp, i


@pytest.mark.parametrize("length,max_len", [(250, 256), (500, 512)])
def test_leap_history_backtrack_long_reads(length, max_len):
    """LEAP CIGARs at L > 253 (want_history + leap_backtrack): passed and
    penalty equal the emulator, and every edit list re-scores to its
    penalty."""
    from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch

    cfg = AlignConfig(k=3, max_len=max_len, leap_af_threshold=64)
    reads, refs = generate_dataset(16, length, 0.05, 0.96, seed=length)
    a = [jnp.asarray(v) for v in encode_batch(reads, refs, max_len)]
    h = leap_align(*a, cfg, want_history=True)
    pen = np.asarray(h["penalty"])
    passed = np.asarray(h["passed"])
    shift = np.asarray(h["lane_shift"])
    for i, r in enumerate(leap_backtrack_batch(h, cfg)):
        e_pass, e_ed, _ = leap_ref(reads[i], refs[i], k=3, af_threshold=64,
                                   max_len=max_len)
        assert (bool(passed[i]), int(pen[i])) == (e_pass, e_ed), i
        if r is None:
            continue
        edits, _ = r
        skip = abs(int(shift[i]))
        score = sum(cfg.x if op == "M" else (cfg.o if op_open else cfg.e)
                    for op, _, op_open in edits[skip:-1])
        assert score == pen[i], i
