"""Benchmark / evaluation harness (layer L4 of the reference).

Batched re-design of GASMA/benchmark/: the reference's per-pair loop
(benchmark_utils.h:373-385 — NW via parasail, LEAP, Greedy, one pair at a
time) becomes chunked batched kernel launches with device-side accuracy
counters; the report format mirrors benchmark::print
(benchmark_utils.h:390-402).
"""

from asm_tpu.bench.harness import BenchmarkResult, run_benchmark, format_report

__all__ = ["BenchmarkResult", "run_benchmark", "format_report"]
