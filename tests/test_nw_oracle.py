"""The NW oracle (kernels/nw.py) against the scalar emulator nw_ref.

NW is the accuracy oracle of the benchmark: its penalties must be exact
for every penalty shape, length extreme and error profile, and its
traceback must be an optimal alignment whose match mask is what the
coverage metric reads.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest

from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import decode_string, encode_batch
from asm_tpu.kernels.nw import nw_align, nw_penalty
from asm_tpu.ops.cigar import batch_nw_cigars
from asm_tpu.reference_impl.nw_ref import nw_ref

EXTREMES = (["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC"],
            ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20])


def _strings(corpus):
    rc, rl, fc, fl = corpus
    return [(decode_string(rc[i], int(rl[i])), decode_string(fc[i], int(fl[i])))
            for i in range(rc.shape[0])]


def _check_penalties(corpus, x=1, o=1, e=1, limit=None):
    pen = np.asarray(nw_penalty(*map(jnp.asarray, corpus), x=x, o=o, e=e))
    for i, (s1, s2) in enumerate(_strings(corpus)[:limit]):
        assert pen[i] == nw_ref(s1, s2, x, o, e, traceback=False)[0], i
    return pen


def _replay(s1, s2, cigar, x, o, e):
    """Cost of a CIGAR, checking it consumes both strings exactly."""
    i1 = i2 = cost = 0
    for run_s, op in re.findall(r"(\d+)([=XID])", cigar):
        run = int(run_s)
        if op == "=":
            assert s1[i1:i1 + run] == s2[i2:i2 + run]
            i1, i2 = i1 + run, i2 + run
        elif op == "X":
            assert all(s1[i1 + t] != s2[i2 + t] for t in range(run))
            cost += x * run
            i1, i2 = i1 + run, i2 + run
        else:
            cost += o + (run - 1) * e
            if op == "I":
                i1 += run
            else:
                i2 += run
    assert (i1, i2) == (len(s1), len(s2))
    return cost


@pytest.mark.parametrize("x,o,e", [(1, 1, 1), (2, 3, 1)])
def test_nw_penalty_matches_emulator(x, o, e):
    _check_penalties(generate_dataset_arrays(48, 100, 0.15, 0.8, seed=3),
                     x, o, e)


@pytest.mark.parametrize("x,o,e", [(1, 1, 1), (2, 3, 1), (1, 4, 2)])
def test_nw_length_extremes(x, o, e):
    """Empty, single-character, full-width and length-skewed pairs."""
    _check_penalties(encode_batch(*EXTREMES, 128), x, o, e)


@pytest.mark.parametrize("x,o,e", [(1, 1, 1), (2, 3, 1)])
def test_nw_traceback_and_match_mask(x, o, e):
    """The traceback is an optimal alignment, and the match mask marks
    exactly the read positions inside '=' runs of length >= 3 (what the
    coverage metric collects, benchmark_coverage.h:26-67)."""
    corpus = generate_dataset_arrays(32, 100, 0.15, 0.8, seed=3)
    pen, ops, mask = nw_align(*map(jnp.asarray, corpus), x=x, o=o, e=e,
                              match_mask_threshold=3)
    pen, mask = np.asarray(pen), np.asarray(mask)
    cigars = batch_nw_cigars(np.asarray(ops))
    for i, (s1, s2) in enumerate(_strings(corpus)):
        assert pen[i] == nw_ref(s1, s2, x, o, e, traceback=False)[0], i
        assert _replay(s1, s2, cigars[i], x, o, e) == pen[i], i
        want = np.zeros(mask.shape[1], bool)
        pos = 0
        for run_s, op in re.findall(r"(\d+)([=XID])", cigars[i]):
            run = int(run_s)
            if op == "=" and run >= 3:
                want[pos:pos + run] = True
            if op in "=XI":
                pos += run
        np.testing.assert_array_equal(mask[i], want, err_msg=str(i))


def test_nw_traceback_length_extremes():
    corpus = encode_batch(*EXTREMES, 128)
    pen, ops = nw_align(*map(jnp.asarray, corpus))
    cigars = batch_nw_cigars(np.asarray(ops))
    for i, (s1, s2) in enumerate(zip(*EXTREMES)):
        assert _replay(s1, s2, cigars[i], 1, 1, 1) == int(pen[i]), i


@pytest.mark.parametrize("err,mr", [(0.05, 0.96), (0.20, 0.96), (0.4, 0.5)])
def test_nw_error_profiles_match_emulator(err, mr):
    _check_penalties(generate_dataset_arrays(32, 100, err, mr, seed=11))


@pytest.mark.parametrize("err,mr", [(0.05, 0.96), (0.20, 0.96), (0.4, 0.5)])
def test_nw_align_penalty_equals_nw_penalty(err, mr):
    """The traceback program's penalties are the penalty program's."""
    a = [jnp.asarray(v)
         for v in generate_dataset_arrays(300, 100, err, mr, seed=12)]
    pen, _ = nw_align(*a)
    np.testing.assert_array_equal(np.asarray(pen), np.asarray(nw_penalty(*a)))


@pytest.mark.parametrize("batch", [1, 37])
def test_nw_batch_composition_invariant(batch):
    a = [jnp.asarray(v)
         for v in generate_dataset_arrays(96, 100, 0.1, 0.9, seed=13)]
    whole = np.asarray(nw_penalty(*a))
    part = np.asarray(nw_penalty(*(v[:batch] for v in a)))
    np.testing.assert_array_equal(part, whole[:batch])


def test_nw_mixed_difficulty_matches_emulator():
    """Easy, hard and pathological indel-heavy pairs in one batch."""
    blocks = [generate_dataset_arrays(8, 100, r, mr, seed=70 + j)
              for j, (r, mr) in enumerate([(0.02, 0.96), (0.10, 0.96),
                                           (0.20, 0.96), (0.45, 0.10)])]
    _check_penalties([np.concatenate([b[i] for b in blocks])
                      for i in range(4)])


def test_nw_symmetric_under_swap():
    """With equal insert/delete costs the global penalty is symmetric."""
    rc, rl, fc, fl = (jnp.asarray(v) for v in
                      generate_dataset_arrays(128, 100, 0.2, 0.6, seed=80))
    for x, o, e in [(1, 1, 1), (2, 3, 1)]:
        np.testing.assert_array_equal(
            np.asarray(nw_penalty(rc, rl, fc, fl, x=x, o=o, e=e)),
            np.asarray(nw_penalty(fc, fl, rc, rl, x=x, o=o, e=e)))


def test_nw_variable_lengths_match_emulator():
    _check_penalties(generate_dataset_arrays(32, 100, 0.12, 0.8, seed=95,
                                             length_range=(40, 120)))


def test_nw_identical_pairs_cost_zero():
    rc, rl, _, _ = generate_dataset_arrays(64, 100, 0.1, seed=96)
    pen = np.asarray(nw_penalty(*map(jnp.asarray, (rc, rl, rc, rl))))
    assert (pen == 0).all()


def test_nw_penalty_bounds():
    """0 <= penalty <= the all-gap alignment's cost, and the penalty is at
    least the length difference's gap cost."""
    rc, rl, fc, fl = generate_dataset_arrays(256, 100, 0.3, 0.5, seed=97)
    pen = np.asarray(nw_penalty(*map(jnp.asarray, (rc, rl, fc, fl))))
    m, n = rl.astype(int), fl.astype(int)
    all_gaps = np.where(m > 0, 1 + (m - 1), 0) + np.where(n > 0, 1 + (n - 1),
                                                          0)
    d = np.abs(m - n)
    assert (pen >= np.where(d > 0, 1 + (d - 1), 0)).all()
    assert (pen <= all_gaps).all()
