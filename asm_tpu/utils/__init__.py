"""Utilities: profiling/counters, structured logging, corpus caching."""

from asm_tpu.utils.profiling import (
    Timer,
    KernelStats,
    trace_to,
)
from asm_tpu.utils.corpus_cache import save_corpus, load_corpus

__all__ = [
    "Timer",
    "KernelStats",
    "trace_to",
    "save_corpus",
    "load_corpus",
]
