"""Profiling and performance counters.

The reference's entire observability stack is `times()` syscall deltas
around each algorithm (benchmark_utils.h:84-89) and printf. The
equivalents here:

  * Timer — wall-clock spans that end with `jax.block_until_ready` on the
    span's result, so device work is inside the span;
  * KernelStats — derived counters: alignments/s and DP cells/s (cells =
    L1*L2 for NW, lanes*L for the banded kernels) — the reference reports
    only seconds;
  * trace_to — context manager around jax.profiler for on-device traces
    viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import jax


def scoped(name: str):
    """Decorator: run the function under `jax.named_scope(name)`, so its
    operations carry a stable name in HLO metadata and profiler traces."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


class Timer:
    """Accumulating wall-clock timer with device-barrier stops."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result_tree=None):
        if result_tree is not None:
            jax.block_until_ready(result_tree)
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return self.total

    @contextlib.contextmanager
    def span(self):
        """with t.span() as out: ...; out["result"] = tree  (barrier on exit)."""
        self.start()
        out = {}
        yield out
        self.stop(out.get("result"))


@dataclasses.dataclass
class KernelStats:
    """Throughput counters for one kernel pass."""

    pairs: int
    seconds: float
    cells_per_pair: int = 0  # DP cells (or lane positions) per pair

    @property
    def aligns_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def cells_per_sec(self) -> float:
        return self.pairs * self.cells_per_pair / self.seconds \
            if self.seconds else 0.0

    def line(self, name: str) -> str:
        s = f"{name:>18} | {self.seconds:8.3f} s | " \
            f"{self.aligns_per_sec / 1e6:8.3f}M aligns/s"
        if self.cells_per_pair:
            s += f" | {self.cells_per_sec / 1e9:8.2f}G cells/s"
        return s


@contextlib.contextmanager
def trace_to(logdir: str):
    """jax.profiler trace span (view with TensorBoard / xprof). Profiler
    errors propagate: a run asked to trace must not silently run untraced."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
