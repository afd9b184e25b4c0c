"""ctypes bindings for the native runtime (native/libasm_native.so).

The compute path of the framework is JAX on the device; the runtime around it
— corpus IO, 2-bit packing, the WFA-style generator, and the mapper's
FM-index — is native C++ (native/src/*.cpp), the batched framework's equivalent of
the reference's host-side C++ (bit_convert.cpp, benchmark_dataset.h,
SeqAn3 indexer/mapper). Python falls back to the pure-NumPy
implementations in asm_tpu.data when the library is unavailable.

The library builds on demand with `make -C native` (g++; no external
deps). `load_native(required=False)` returns None if it cannot be built.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libasm_native.so")

_lib = None
_load_failed = False


def _configure(lib):
    c = ctypes
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.asm_count_pairs.restype = c.c_int64
    lib.asm_count_pairs.argtypes = [c.c_char_p, c.c_int64]
    lib.asm_read_pair_file.restype = c.c_int64
    lib.asm_read_pair_file.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32, c.c_int32, i8p, i32p, i8p, i32p,
    ]
    lib.asm_read_fasta.restype = c.c_int64
    lib.asm_read_fasta.argtypes = [
        c.c_char_p, i8p, c.c_int64, i64p, c.c_int64, i64p,
    ]
    lib.asm_read_fastq.restype = c.c_int64
    lib.asm_read_fastq.argtypes = [c.c_char_p, c.c_int64, c.c_int32, i8p, i32p]
    lib.asm_read_fastq_names.restype = c.c_int64
    lib.asm_read_fastq_names.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32, c.c_char_p,
    ]
    lib.asm_generate_dataset.restype = None
    lib.asm_generate_dataset.argtypes = [
        c.c_int64, c.c_int32, c.c_double, c.c_double, c.c_int32, c.c_uint64,
        c.c_int32, i8p, i32p, i8p, i32p,
    ]
    lib.asm_write_pair_file.restype = c.c_int64
    lib.asm_write_pair_file.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32, i8p, i32p, i8p, i32p,
    ]

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.asm_coverage_batch.restype = c.c_int64
    lib.asm_coverage_batch.argtypes = [
        c.c_int64, c.c_int32, i8p, i32p, i8p, i32p, c.c_int32, i8p,
        c.c_int32, c.c_int32, c.c_int32, u8p,
    ]

    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.asm_cigar_strings.restype = c.c_int64
    lib.asm_cigar_strings.argtypes = [
        u16p, c.c_int64, c.c_int32, u8p, c.c_int64, i32p,
    ]
    lib.asm_window_pack.restype = c.c_int64
    lib.asm_window_pack.argtypes = [
        i8p, c.c_int64, i64p, i32p, c.c_int64, c.c_int32, u8p,
    ]

    lib.asm_fm_build.restype = c.c_void_p
    lib.asm_fm_build.argtypes = [i8p, c.c_int64]
    lib.asm_fm_free.restype = None
    lib.asm_fm_free.argtypes = [c.c_void_p]
    lib.asm_fm_length.restype = c.c_int64
    lib.asm_fm_length.argtypes = [c.c_void_p]
    lib.asm_fm_search.restype = c.c_int64
    lib.asm_fm_search.argtypes = [
        c.c_void_p, i8p, c.c_int32,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),
    ]
    lib.asm_fm_locate.restype = c.c_int64
    lib.asm_fm_locate.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, i64p,
    ]
    lib.asm_fm_candidates.restype = c.c_int64
    lib.asm_fm_candidates.argtypes = [
        c.c_void_p, i8p, i32p, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, i64p, i32p,
    ]
    lib.asm_fm_save.restype = c.c_int32
    lib.asm_fm_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.asm_fm_load.restype = c.c_void_p
    lib.asm_fm_load.argtypes = [c.c_char_p]

    # hostmem runtime (native/src/hostmem.cpp): hugepage-backed
    # parallel-prefaulted buffers + the host corpus pipeline
    lib.asm_host_alloc.restype = c.c_void_p
    lib.asm_host_alloc.argtypes = [c.c_int64, c.c_int32]
    lib.asm_host_free.restype = None
    lib.asm_host_free.argtypes = [c.c_void_p, c.c_int64]
    lib.asm_prefault.restype = None
    lib.asm_prefault.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
    lib.asm_difficulty_sort.restype = None
    lib.asm_difficulty_sort.argtypes = [
        i8p, i8p, c.c_int64, c.c_int32, i64p, c.c_int32,
    ]
    lib.asm_apply_perm_rows.restype = None
    lib.asm_apply_perm_rows.argtypes = [
        c.c_void_p, i64p, c.c_void_p, c.c_int64, c.c_int64, c.c_int32,
    ]
    lib.asm_read_into.restype = c.c_int64
    lib.asm_read_into.argtypes = [
        c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, c.c_int32,
    ]
    lib.asm_write_from.restype = c.c_int64
    lib.asm_write_from.argtypes = [c.c_char_p, c.c_int64, c.c_void_p, c.c_int64]
    return lib


def build_native() -> float:
    """`make -C native`, serialized across processes by a file lock (test
    workers may all find the library missing at once); returns seconds."""
    import fcntl
    import time

    t0 = time.perf_counter()
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    return time.perf_counter() - t0


def load_native(required: bool = False):
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed and not required:
        return None
    try:
        if not os.path.exists(_LIB_PATH):
            build_native()
        _lib = _configure(ctypes.CDLL(_LIB_PATH))
        return _lib
    except (OSError, subprocess.CalledProcessError) as exc:
        _load_failed = True
        if required:
            raise RuntimeError(f"native library unavailable: {exc}") from exc
        return None


# ---- pythonic wrappers --------------------------------------------------

def read_pair_file_native(path, max_pairs, max_len=128, skip_first_char=True):
    """Pair file -> encoded arrays, via C++ (benchmark_utils.h:325-352)."""
    lib = load_native(required=True)
    rc = np.empty((max_pairs, max_len), np.int8)
    fc = np.empty((max_pairs, max_len), np.int8)
    rl = np.empty(max_pairs, np.int32)
    fl = np.empty(max_pairs, np.int32)
    n = lib.asm_read_pair_file(
        path.encode(), max_pairs, max_len, int(skip_first_char), rc, rl, fc, fl
    )
    if n < 0:
        raise IOError(f"cannot read {path}")
    return rc[:n], rl[:n], fc[:n], fl[:n]


def generate_dataset_native(num_reads, length, error_rate, mismatch_rate=0.96,
                            exact_error_rate=True, seed=0, max_len=128):
    """C++ corpus generator (benchmark_dataset.h process; own RNG stream)."""
    lib = load_native(required=True)
    # hugepage-prefaulted outputs: the generator writes ~2 GB for 8M
    # pairs, and plain np.empty pages fault in at ~16 MB/s on this VM
    from asm_tpu.utils.hostmem import host_array

    rc = host_array((num_reads, max_len), np.int8)
    fc = host_array((num_reads, max_len), np.int8)
    rl = host_array(num_reads, np.int32)
    fl = host_array(num_reads, np.int32)
    lib.asm_generate_dataset(
        num_reads, length, error_rate, mismatch_rate, int(exact_error_rate),
        seed, max_len, rc, rl, fc, fl,
    )
    return rc, rl, fc, fl


def write_pair_file_native(path, rc, rl, fc, fl):
    lib = load_native(required=True)
    n = lib.asm_write_pair_file(
        path.encode(), rc.shape[0], rc.shape[1],
        np.ascontiguousarray(rc), np.ascontiguousarray(rl),
        np.ascontiguousarray(fc), np.ascontiguousarray(fl),
    )
    if n < 0:
        raise IOError(f"cannot write {path}")


def read_fasta_native(path, capacity=1 << 26, max_records=1 << 16):
    """FASTA -> (codes int8[total], record_starts int64[n_records])."""
    lib = load_native(required=True)
    codes = np.empty(capacity, np.int8)
    starts = np.empty(max_records, np.int64)
    nrec = np.zeros(1, np.int64)
    total = lib.asm_read_fasta(
        path.encode(), codes, capacity, starts, max_records, nrec
    )
    if total < 0:
        raise IOError(f"cannot read FASTA {path} (code {total})")
    return codes[:total].copy(), starts[: int(nrec[0])].copy()


def read_fastq_native(path, max_reads, max_len=128, name_cap=64):
    """FASTQ -> (codes int8[n, max_len], lens int32[n], names list[str]).

    NOTE: two native passes over the file (sequences, then names); fine at
    mapper scale, and the min(n, n2) guard below drops any skew if the
    file changes between passes."""
    lib = load_native(required=True)
    codes = np.empty((max_reads, max_len), np.int8)
    lens = np.empty(max_reads, np.int32)
    n = lib.asm_read_fastq(path.encode(), max_reads, max_len, codes, lens)
    if n < 0:
        raise IOError(f"cannot read FASTQ {path}")
    buf = ctypes.create_string_buffer(int(max_reads) * name_cap)
    n2 = lib.asm_read_fastq_names(path.encode(), max_reads, name_cap, buf)
    raw = buf.raw  # one copy: `buf.raw` copies the whole buffer per access
    names = [
        raw[i * name_cap: (i + 1) * name_cap].split(b"\0", 1)[0].decode()
        for i in range(int(min(n, n2)))
    ]
    return codes[:n], lens[:n], names


def coverage_batch_native(read_codes, read_len, g_ops, g_runs, nw_cols,
                          threshold1=1, threshold2=3):
    """Batched LCM-coverage check (benchmark_coverage.h semantics) in C++.

    g_ops/g_runs: greedy (op, run) slot buffers [n, C]; nw_cols: NW
    traceback per-column ops [n, 2L] in reverse order (device layout).
    Returns bool[n]."""
    lib = load_native(required=True)
    n = read_codes.shape[0]
    covered = np.empty(n, np.uint8)
    lib.asm_coverage_batch(
        n, read_codes.shape[1],
        np.ascontiguousarray(read_codes, np.int8),
        np.ascontiguousarray(read_len, np.int32),
        np.ascontiguousarray(g_ops, np.int8),
        np.ascontiguousarray(g_runs, np.int32),
        g_ops.shape[1],
        np.ascontiguousarray(nw_cols, np.int8),
        nw_cols.shape[1], threshold1, threshold2, covered,
    )
    return covered.astype(bool)


def window_pack_native(genome: np.ndarray, starts: np.ndarray,
                       spans: np.ndarray, L: int,
                       out: np.ndarray | None = None) -> np.ndarray | None:
    """Gather + 2-bit-pack candidate windows from a genome in one
    threaded native call (the mapper's upload format). Returns None when
    the library is unavailable (caller falls back to numpy)."""
    lib = load_native(required=False)
    if lib is None:
        return None
    n = starts.shape[0]
    if out is None:
        out = np.empty((n, L // 4), np.uint8)
    lib.asm_window_pack(
        np.ascontiguousarray(genome, np.int8), genome.shape[0],
        np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(spans, np.int32), n, L, out)
    return out


def cigar_strings_packed(packed: np.ndarray) -> list[str]:
    """Packed uint16 greedy records (op << 13 | run, the mapper's pull
    format) -> CIGAR strings via the threaded native decoder. Falls back
    to the NumPy path when the library is unavailable."""
    lib = load_native(required=False)
    n, slots = packed.shape
    if lib is None:
        from asm_tpu.ops.cigar import runs_to_cigars_batch
        return runs_to_cigars_batch((packed >> 13).astype(np.int8),
                                    (packed & 0x1FFF).astype(np.int32))
    stride = 5 * slots
    out = np.empty((n, stride), np.uint8)
    lens = np.empty(n, np.int32)
    lib.asm_cigar_strings(np.ascontiguousarray(packed, np.uint16), n,
                          slots, out, stride, lens)
    ob = out.tobytes()
    return [ob[i * stride: i * stride + lens[i]].decode()
            for i in range(n)]


class FMIndex:
    """Pythonic handle over the native FM-index (see native/src/fmindex.cpp)."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @classmethod
    def build(cls, codes: np.ndarray) -> "FMIndex":
        lib = load_native(required=True)
        h = lib.asm_fm_build(np.ascontiguousarray(codes, np.int8),
                             codes.shape[0])
        if not h:
            raise RuntimeError("FM-index build failed")
        return cls(h, lib)

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        lib = load_native(required=True)
        h = lib.asm_fm_load(path.encode())
        if not h:
            raise IOError(f"cannot load index {path}")
        return cls(h, lib)

    def save(self, path: str) -> None:
        if self._lib.asm_fm_save(self._h, path.encode()) != 0:
            raise IOError(f"cannot save index {path}")

    def __len__(self) -> int:
        return int(self._lib.asm_fm_length(self._h))

    def search(self, pattern: np.ndarray) -> tuple[int, int]:
        """Exact backward search; returns SA range (lo, hi)."""
        lo = ctypes.c_int64()
        hi = ctypes.c_int64()
        self._lib.asm_fm_search(
            self._h, np.ascontiguousarray(pattern, np.int8),
            pattern.shape[0], ctypes.byref(lo), ctypes.byref(hi),
        )
        return lo.value, hi.value

    def locate(self, lo: int, hi: int, cap: int = 1024) -> np.ndarray:
        pos = np.empty(cap, np.int64)
        k = self._lib.asm_fm_locate(self._h, lo, hi, cap, pos)
        return pos[:k].copy()

    def candidates_batch(
        self,
        read_codes: np.ndarray,
        read_lens: np.ndarray,
        max_errors: int = 3,
        max_hits_per_seed: int = 16,
        max_candidates: int = 64,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pigeonhole candidate starts for a WHOLE read batch in one
        native call (repetitive seeds sampled, not skipped — see
        asm_fm_candidates in fmindex.cpp). Returns (starts int64
        [n, max_candidates], counts int32 [n])."""
        n, stride = read_codes.shape
        starts = np.zeros((n, max_candidates), np.int64)
        counts = np.zeros(n, np.int32)
        self._lib.asm_fm_candidates(
            self._h, np.ascontiguousarray(read_codes, np.int8),
            np.ascontiguousarray(read_lens, np.int32), n, stride,
            max_errors, max_hits_per_seed, max_candidates, starts, counts,
        )
        return starts, counts

    def __del__(self):
        try:
            self._lib.asm_fm_free(self._h)
        except Exception:
            pass
