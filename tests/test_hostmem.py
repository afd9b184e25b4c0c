"""Hostmem runtime: prefaulted arrays, native sort/gather/IO/staging.

These pin the native fast paths bit-identical to their numpy fallbacks —
callers (corpus_cache, take_rows) switch between them based on library
availability, so they must be interchangeable.
"""

import os

import numpy as np
import pytest

from asm_tpu.native import load_native
from asm_tpu.utils.hostmem import host_array, read_into, take_rows, write_from

needs_native = pytest.mark.skipif(
    load_native() is None, reason="native runtime unavailable"
)


def test_host_array_zeroed_and_writable():
    a = host_array((513, 67), np.int32)
    assert a.shape == (513, 67) and a.dtype == np.int32
    assert (a == 0).all()
    a[:] = -5
    assert (a == -5).all()


def test_take_rows_matches_fancy_index():
    rng = np.random.default_rng(0)
    src = rng.integers(-100, 100, (1000, 33)).astype(np.int16)
    perm = rng.permutation(1000)
    np.testing.assert_array_equal(np.asarray(take_rows(src, perm)),
                                  src[perm])
    v = rng.integers(0, 9, 1000).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(take_rows(v, perm)), v[perm])


@needs_native
def test_difficulty_sort_native_matches_numpy_argsort():
    from asm_tpu.parallel.schedule import difficulty_proxy

    rng = np.random.default_rng(7)
    B, L = 4096, 128
    rc = rng.integers(0, 6, (B, L)).astype(np.int8)
    fc = rng.integers(0, 6, (B, L)).astype(np.int8)
    # force many ties so stability is actually exercised
    fc[: B // 2] = rc[: B // 2]
    ref = np.argsort(difficulty_proxy(rc, 0, fc, 0), kind="stable")
    lib = load_native(required=True)
    perm = np.empty(B, np.int64)
    lib.asm_difficulty_sort(rc, fc, B, L, perm, 0)
    np.testing.assert_array_equal(perm, ref)


@needs_native
def test_read_write_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 255, (777, 13)).astype(np.uint8)
    b = rng.standard_normal(99).astype(np.float32)
    p = str(tmp_path / "blob.bin")
    open(p, "wb").close()
    write_from(p, 0, a)
    write_from(p, a.nbytes, b)
    assert os.path.getsize(p) == a.nbytes + b.nbytes
    a2 = host_array(a.shape, a.dtype)
    b2 = host_array(b.shape, b.dtype)
    read_into(p, 0, a2)
    read_into(p, a.nbytes, b2)
    np.testing.assert_array_equal(np.asarray(a2), a)
    np.testing.assert_array_equal(np.asarray(b2), b)


def test_take_rows_fallback_without_native(monkeypatch):
    """With no native library take_rows is plain fancy indexing, so the
    two paths are interchangeable."""
    import asm_tpu.utils.hostmem as hm

    rng = np.random.default_rng(8)
    src = rng.integers(-9, 9, (513, 7)).astype(np.int32)
    perm = rng.permutation(513)
    native = np.asarray(take_rows(src, perm))
    monkeypatch.setattr(hm, "load_native", lambda *a, **k: None)
    np.testing.assert_array_equal(np.asarray(hm.take_rows(src, perm)),
                                  native)


def test_build_native_is_idempotent():
    """build_native (the locked `make -C native`) leaves a loadable
    library and does nothing when it is up to date."""
    from asm_tpu.native import build_native

    assert build_native() >= 0.0
    assert load_native() is not None


def test_corpus_cache_raw_roundtrip(tmp_path):
    from asm_tpu.utils.corpus_cache import load_corpus, save_corpus

    rng = np.random.default_rng(9)
    corpus = (
        rng.integers(0, 6, (65, 128)).astype(np.int8),
        np.full(65, 100, np.int32),
        rng.integers(0, 6, (65, 128)).astype(np.int8),
        np.full(65, 97, np.int32),
    )
    p = str(tmp_path / "corpus.npz")
    save_corpus(p, *corpus, n=65, err=0.05)
    back = load_corpus(p, n=65, err=0.05)
    assert back is not None
    for a, b in zip(corpus, back):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert load_corpus(p, n=66, err=0.05) is None


@needs_native
def test_corpus_cache_upgrades_npz_to_raw(tmp_path):
    from asm_tpu.utils.corpus_cache import load_corpus

    rng = np.random.default_rng(11)
    corpus = (
        rng.integers(0, 6, (17, 64)).astype(np.int8),
        np.full(17, 50, np.int32),
        rng.integers(0, 6, (17, 64)).astype(np.int8),
        np.full(17, 51, np.int32),
    )
    p = str(tmp_path / "old.npz")
    meta = np.array(sorted(dict(n=17).items()), dtype=object)
    np.savez(p, read_codes=corpus[0], read_len=corpus[1],
             ref_codes=corpus[2], ref_len=corpus[3], _params=meta)
    back = load_corpus(p, n=17)
    assert back is not None
    assert os.path.exists(str(tmp_path / "old.bin"))  # upgraded
    back2 = load_corpus(p, n=17)  # now served from raw
    for a, b in zip(back, back2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
