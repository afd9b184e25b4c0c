"""Hugepage-backed, parallel-prefaulted host arrays.

On this kernel class first-touch faults dominate any fresh multi-GB
numpy allocation (observed as low as ~16 MB/s — a 1 GB buffer costs
~60 s before any compute). Measured root cause: transparent-hugepage
allocation at fault time is ~60x SLOWER than plain 4k faults here
(~11 MB/s vs ~680 MB/s single-threaded), and 4k faulting scales with
threads (~2.8 GB/s on 4 cores). The native runtime
(native/src/hostmem.cpp) therefore allocates mmap regions with
MADV_NOHUGEPAGE and first-touches them with all cores; `host_array`
wraps one as a numpy array. Everything degrades to plain numpy when the
native library is unavailable — results are identical, only slower.

Role analogue in the reference: none (it streams pairs one at a time,
benchmark_utils.h:373); this is the data-loading/allocator layer a
large-batch pipeline needs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from asm_tpu.native import load_native


def host_array(shape, dtype, nthreads: int = 0) -> np.ndarray:
    """np.empty(shape, dtype), but NOHUGEPAGE-backed and pre-faulted.

    Contents start zeroed (fresh anonymous pages). Falls back to
    np.zeros when the native runtime is unavailable.

    The region is a python mmap object so its lifetime follows the
    BUFFER PROTOCOL: any consumer that exports the buffer (numpy views,
    jax.device_put's zero-copy CPU path) keeps the memory alive. The
    previous implementation freed a raw native allocation from a GC
    finalizer on the wrapping ndarray — jax.device_put with a sharding
    takes per-shard views without keeping that ndarray referenced, so an
    inline-staged corpus could be freed MID-TRANSFER (observed as
    scrambled costs in the sharded planes_tiled path).
    """
    import mmap

    shape = (shape,) if np.isscalar(shape) else tuple(shape)
    dtype = np.dtype(dtype)
    size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    lib = load_native()
    if lib is None or size == 0:
        return np.zeros(shape, dtype)
    m = mmap.mmap(-1, size)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(m))
    # MADV_NOHUGEPAGE + parallel first-touch (see module docstring)
    MADV_NOHUGEPAGE = 15
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(size),
                     MADV_NOHUGEPAGE)
    except Exception:
        pass
    lib.asm_prefault(ctypes.c_void_p(addr), size, nthreads)
    return np.frombuffer(m, dtype=dtype).reshape(shape)


def take_rows(src: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """src[perm] for 1-D/2-D arrays, gathered in parallel into a
    prefaulted buffer (the numpy fancy-index equivalent without the
    16 MB/s first-touch tax)."""
    src = np.ascontiguousarray(src)
    perm = np.ascontiguousarray(perm, np.int64)
    lib = load_native()
    if lib is None:
        return src[perm]
    dst = host_array((perm.shape[0],) + src.shape[1:], src.dtype)
    rowbytes = src.dtype.itemsize * int(
        np.prod(src.shape[1:], dtype=np.int64))
    lib.asm_apply_perm_rows(
        src.ctypes.data_as(ctypes.c_void_p), perm,
        dst.ctypes.data_as(ctypes.c_void_p),
        perm.shape[0], rowbytes, 0,
    )
    return dst


def read_into(path: str, offset: int, arr: np.ndarray) -> None:
    """Parallel positioned read of arr.nbytes at offset into arr."""
    lib = load_native(required=True)
    got = lib.asm_read_into(
        path.encode(), offset, arr.ctypes.data_as(ctypes.c_void_p),
        arr.nbytes, 0,
    )
    if got != arr.nbytes:
        raise IOError(f"short read from {path}: {got} != {arr.nbytes}")


def write_from(path: str, offset: int, arr: np.ndarray) -> None:
    lib = load_native(required=True)
    arr = np.ascontiguousarray(arr)
    put = lib.asm_write_from(
        path.encode(), offset, arr.ctypes.data_as(ctypes.c_void_p),
        arr.nbytes,
    )
    if put != arr.nbytes:
        raise IOError(f"short write to {path}: {put} != {arr.nbytes}")
