"""Hermetic test of the three-way benchmark harness (asm_tpu.bench).

The harness is the reference-report surface (benchmark_utils.h:390-402):
its accuracy and coverage numbers must be exactly what the scalar
emulators and the host coverage check give on the same corpus.
"""

from asm_tpu.bench.harness import format_report, run_benchmark
from asm_tpu.config import AlignConfig
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import decode_string
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.nw_ref import nw_ref


def test_harness_accuracies_match_emulators():
    corpus = generate_dataset_arrays(96, 100, 0.10, 0.96, seed=4)
    cfg = AlignConfig()
    r = run_benchmark(*corpus, cfg=cfg, chunk=64, coverage_sample=64)
    assert r.total == 96 and r.coverage_checked == 64
    assert r.nw_accuracy == 1.0 and r.platform == "cpu"
    rc, rl, fc, fl = corpus
    nw = greedy = leap = 0
    for i in range(96):
        s1 = decode_string(rc[i], int(rl[i]))
        s2 = decode_string(fc[i], int(fl[i]))
        opt, _ = nw_ref(s1, s2, traceback=False)
        greedy += greedy_ref(s1, s2, k=3)[0] == opt
        leap += leap_ref(s1, s2, k=3, af_threshold=200)[1] == opt
    assert r.greedy_accuracy == greedy / 96
    assert r.leap_accuracy == leap / 96
    assert 0.5 < r.greedy_coverage <= 1.0
    report = format_report(r)
    assert "Benchmark Results" in report and "on cpu" in report
