"""Proof that asm_tpu's main path runs on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py          # phases 1-6 on one card
    python chip_smoke.py --four   # only the four-card data-parallel phase

One process holds the card(s); nothing here starts a second JAX process
on a GPU (the emulator pool of phase 3 runs with JAX_PLATFORMS=cpu).
The phases, each printing what it found:

  1. device   — JAX sees a GPU; nvidia-smi name and power limit; the
                 native runtime is built (`make -C native`, set-up time).
  2. compile  — two 1M-pair corpora (err 0.05 and 0.20, seed 42, the
                 reference benchmark's shape) and every main-path program
                 lowered and compiled at its real width, with
                 memory_analysis(): NW penalty, NW traceback with the
                 coverage match mask, LEAP penalty, greedy cost-only and
                 with CIGARs, the coverage step, the mapper's scoring step.
  3. reference — the compiled kernels against the scalar emulators
                 (asm_tpu.reference_impl) on 2,048 sampled pairs per rate:
                 NW and LEAP exactly; greedy costs exactly at err 0.05 and
                 within 1% tie flips at err 0.20 (the significance
                 heuristic's exact float ties, greedy_ref docstring).
  4. harness  — `run_benchmark` on both corpora (full-corpus coverage) and
                 the reference-format report; greedy accuracy and coverage
                 within 0.5 percentage points of BASELINE.md.
  5. greedy   — end-to-end time (int8 corpus in host memory -> costs in
                 host memory) and device time (5 reps after warm-up) at 1M
                 pairs and at the largest power-of-two chunk that fits.
  6. mapper   — a 50 Mbp seeded genome, 100k reads at the real-data error
                 profile, through the indexer and mapper CLIs at -e 3;
                 recall on the reads pigeonhole seeding can find.
  7. --four   — make_sharded_pipeline over a 1-D mesh of four cards on
                 4M pairs at err 0.05, per pair equal to the one-card run.

Any failed check raises, and the script exits non-zero. The last line of
standard output is {"ok": true, "device": {"platform": "gpu", "kind":
..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from asm_tpu.bench.harness import (COVERAGE_CHUNK, coverage_step,
                                   format_report, greedy_step, leap_step,
                                   nw_step, run_benchmark)
from asm_tpu.config import AlignConfig
from asm_tpu.encoding import decode_string
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.kernels.leap import leap_align
from asm_tpu.kernels.nw import nw_align
from asm_tpu.mapper.core import MapperConfig, rescore
from asm_tpu.native import build_native, generate_dataset_native
from asm_tpu.runtime import describe, gpu_name_power, use_compile_cache

CFG = AlignConfig(x=1, o=1, e=1, k=3, max_len=128)
PAIRS = 1_000_000
RATES = (0.05, 0.20)
SAMPLE = 2048
# the reference's own published figures (BASELINE.md, README.md:18-67)
BASELINE = {0.05: dict(greedy_accuracy=0.92975, greedy_coverage=0.97512),
            0.20: dict(greedy_accuracy=0.46023, greedy_coverage=0.88289)}
TOLERANCE_PP = 0.5


def log(msg=""):
    print(msg, flush=True)


def phase(name):
    log(f"\n=== {name} ===")
    return time.perf_counter()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def corpus(err, n=None):
    return generate_dataset_native(n or PAIRS, 100, err, mismatch_rate=0.96,
                                   seed=42, max_len=CFG.max_len)


def shapes(batch, width=CFG.max_len, dtype=jnp.int8):
    code = jax.ShapeDtypeStruct((batch, width), dtype)
    length = jax.ShapeDtypeStruct((batch,), jnp.int32)
    return code, length, code, length


def compile_report(name, jitted, args, **static):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    log(f"{name}: compiled in {time.perf_counter() - t0:.1f}s; "
        f"memory_analysis {compiled.memory_analysis()}")
    return compiled


# ---- phase 3 emulator workers (CPU processes, no device use) ------------
def _emulate(job):
    from asm_tpu.reference_impl.greedy_ref import greedy_ref
    from asm_tpu.reference_impl.leap_ref import leap_ref
    from asm_tpu.reference_impl.nw_ref import nw_ref

    s1, s2 = job
    nw, _ = nw_ref(s1, s2, CFG.x, CFG.o, CFG.e, traceback=False)
    greedy, _ = greedy_ref(s1, s2, k=CFG.k, x=CFG.x, o=CFG.o, e=CFG.e)
    passed, leap, shift = leap_ref(
        s1, s2, k=CFG.k, af_threshold=CFG.leap_af_threshold,
        ms_penalty=CFG.x, gap_open_penalty=CFG.o, gap_ext_penalty=CFG.e)
    return nw, greedy, bool(passed), leap, shift


def emulate_all(jobs):
    """Scalar emulators over `jobs` in a spawn pool of CPU-only workers."""
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"  # inherited by the spawned workers
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(max(1, min(16, os.cpu_count() or 1))) as pool:
            return pool.map(_emulate, jobs, chunksize=32)
    finally:
        if saved is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = saved


def one_card():
    # ---- 1. device -------------------------------------------------------
    t0 = phase("1. device")
    log(f"nvidia-smi: {gpu_name_power()}")
    log(f"native runtime build (set-up): {build_native():.1f}s")
    log(f"phase 1: {time.perf_counter() - t0:.1f}s")

    # ---- 2. compile --------------------------------------------------------
    t0 = phase("2. compile")
    corpora = {}
    for err in RATES:
        t1 = time.perf_counter()
        corpora[err] = corpus(err)
        log(f"corpus err={err}: {PAIRS} pairs, native generator, seed 42 "
            f"({time.perf_counter() - t1:.1f}s, set-up)")
    mcfg = MapperConfig()
    full, cov = shapes(PAIRS), shapes(COVERAGE_CHUNK)
    progs = {
        "nw_penalty": compile_report("nw_penalty", nw_step, full, cfg=CFG),
        "nw_align": compile_report(
            "nw_align(match_mask_threshold=3)", nw_align, cov, x=CFG.x,
            o=CFG.o, e=CFG.e, match_mask_threshold=3),
        "leap": compile_report("leap_penalty", leap_step, full, cfg=CFG),
        "greedy": compile_report("greedy (cost only)", greedy_step, full,
                                 cfg=CFG),
        "greedy_cigar": compile_report("greedy (with CIGAR)", greedy_align,
                                       cov, cfg=CFG),
        "coverage": compile_report("coverage_step", coverage_step, cov,
                                   cfg=CFG),
    }
    compile_report("mapper rescore", rescore,
                   shapes(mcfg.batch, CFG.max_len // 4, jnp.uint8),
                   cfg=mcfg.align)
    log(f"phase 2: {time.perf_counter() - t0:.1f}s")

    # ---- 3. reference ------------------------------------------------------
    t0 = phase("3. reference")
    rng = np.random.default_rng(42)
    for err in RATES:
        rc, rl, fc, fl = corpora[err]
        dev = jax.device_put((rc, rl, fc, fl))
        nw = np.asarray(progs["nw_penalty"](*dev))
        greedy = np.asarray(progs["greedy"](*dev))
        leap_out = leap_align(*dev, CFG)
        leap_pen = np.asarray(leap_out["penalty"])
        leap_pass = np.asarray(leap_out["passed"])
        leap_shift = np.asarray(leap_out["lane_shift"])
        idx = np.sort(rng.choice(PAIRS, SAMPLE, replace=False))
        jobs = [(decode_string(rc[i], int(rl[i])),
                 decode_string(fc[i], int(fl[i]))) for i in idx]
        t1 = time.perf_counter()
        want = np.array([(a, b, int(c), d, s)
                         for a, b, c, d, s in emulate_all(jobs)])
        log(f"err={err}: emulators on {SAMPLE} sampled pairs "
            f"({time.perf_counter() - t1:.1f}s)")
        nw_bad = int((nw[idx] != want[:, 0]).sum())
        leap_bad = int(((leap_pen[idx] != want[:, 3])
                        | (leap_pass[idx] != want[:, 2].astype(bool))
                        | (leap_shift[idx] != want[:, 4])).sum())
        greedy_bad = int((greedy[idx] != want[:, 1]).sum())
        log(f"err={err}: NW differs on {nw_bad}/{SAMPLE}, LEAP on "
            f"{leap_bad}/{SAMPLE}, greedy cost on {greedy_bad}/{SAMPLE}")
        check(nw_bad == 0, f"NW != nw_ref on {nw_bad} pairs")
        check(leap_bad == 0, f"LEAP != leap_ref on {leap_bad} pairs")
        limit = 0 if err <= 0.05 else SAMPLE // 100
        check(greedy_bad <= limit,
              f"greedy != greedy_ref on {greedy_bad} pairs (limit {limit})")
    log(f"phase 3: {time.perf_counter() - t0:.1f}s")

    # ---- 4. harness --------------------------------------------------------
    t0 = phase("4. harness")
    for err in RATES:
        log(f"--- simulated err={err:.2f}: {PAIRS} pairs ---")
        r = run_benchmark(*corpora[err], CFG, chunk=1 << 20)
        log(format_report(r))
        for key, ref in BASELINE[err].items():
            got = getattr(r, key)
            log(f"{key}: {100 * got:.3f} % vs reference {100 * ref:.3f} %")
            check(abs(got - ref) * 100 <= TOLERANCE_PP,
                  f"{key} {got:.5f} is more than {TOLERANCE_PP} pp from "
                  f"the reference's {ref:.5f}")
        check(r.coverage_checked == PAIRS, "coverage must check every pair")
    log(f"phase 4: {time.perf_counter() - t0:.1f}s")

    # ---- 5. greedy timing --------------------------------------------------
    t0 = phase("5. greedy")
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
    for err in RATES:
        host = corpora[err]
        fn = progs["greedy"]
        e2e = []
        for _ in range(5):
            t1 = time.perf_counter()
            cost = np.asarray(fn(*jax.device_put(host)))
            e2e.append(time.perf_counter() - t1)
        check(cost.shape == (PAIRS,) and cost.min() >= 0, "bad greedy costs")
        log(f"err={err}: end to end (host int8 -> host costs) {PAIRS} pairs: "
            f"best {min(e2e):.6f}s, runs {[round(t, 6) for t in e2e]}")
        dev = jax.device_put(host)
        per_pair = sum(a.nbytes for a in host) / PAIRS
        chunk = PAIRS
        # largest power-of-two chunk whose inputs take at most a quarter
        # of the device memory limit (the kernel adds 64 B/pair of planes)
        while (2 * chunk) * (per_pair + 80) <= limit / 4:
            chunk *= 2
        for n in sorted({PAIRS, chunk}):
            reps = -(-n // PAIRS)
            args = dev if n == PAIRS else [
                jnp.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n] for a in dev]
            jax.block_until_ready(greedy_step(*args, cfg=CFG))
            ts = []
            for _ in range(5):
                t1 = time.perf_counter()
                jax.block_until_ready(greedy_step(*args, cfg=CFG))
                ts.append(time.perf_counter() - t1)
            log(f"err={err}: device time at chunk {n} pairs: best "
                f"{min(ts):.6f}s ({n / min(ts) / 1e6:.1f}M aligns/s), "
                f"runs {[round(t, 6) for t in ts]}")
            del args
    log(f"phase 5: {time.perf_counter() - t0:.1f}s")

    # ---- 6. mapper ---------------------------------------------------------
    t0 = phase("6. mapper")
    mapper_phase()
    log(f"phase 6: {time.perf_counter() - t0:.1f}s")


def mapper_phase(genome_bp=50_000_000, n_reads=100_000, max_errors=3):
    from asm_tpu.mapper.__main__ import main as mapper_main
    from asm_tpu.mapper.indexer import main as indexer_main
    from asm_tpu.mapper.simulate import sample_reads

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=genome_bp, dtype=np.int8)
    t1 = time.perf_counter()
    reads, lens, origins, nerr = sample_reads(genome, n_reads, 100, rng)
    log(f"genome {genome_bp} bp, {n_reads} reads sampled "
        f"({time.perf_counter() - t1:.1f}s); errors/read mean "
        f"{nerr.mean():.2f}")
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        fa, fq = os.path.join(tmp, "ref.fa"), os.path.join(tmp, "reads.fq")
        ix, sam = os.path.join(tmp, "ref.idx"), os.path.join(tmp, "out.sam")
        with open(fa, "wb") as f:
            f.write(b">chr_sim\n")
            f.write(alphabet[genome].tobytes())
            f.write(b"\n")
        with open(fq, "w") as f:
            for i in range(n_reads):
                s = alphabet[reads[i, :lens[i]]].tobytes().decode()
                f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
        t1 = time.perf_counter()
        indexer_main(["-r", fa, "-o", ix])
        log(f"index build: {time.perf_counter() - t1:.1f}s")
        t1 = time.perf_counter()
        mapper_main(["-r", fa, "-q", fq, "-i", ix, "-o", sam,
                     "-e", str(max_errors)])
        dt = time.perf_counter() - t1
        log(f"mapper CLI: {n_reads} reads in {dt:.1f}s "
            f"(compile and index load included)")
        pos = np.full(n_reads, -(10 ** 12), np.int64)
        with open(sam) as f:
            for line in f:
                if line.startswith("@"):
                    continue
                q = line.split("\t")
                if q[2] != "*":
                    pos[int(q[0][1:])] = int(q[3]) - 1
    ok = np.abs(pos - origins) <= 5
    elig = nerr <= max_errors
    recall_elig = float(ok[elig].mean())
    log(f"recall (|pos - origin| <= 5): {ok.mean():.4f} overall, "
        f"{recall_elig:.4f} on {int(elig.sum())} pigeonhole-eligible reads")
    check(recall_elig >= 0.995, f"eligible recall {recall_elig:.4f} < 0.995")


def four_cards():
    from asm_tpu.parallel import make_mesh, shard_batch
    from asm_tpu.parallel.runner import make_sharded_pipeline

    t0 = phase("7. four cards")
    log(f"nvidia-smi: {gpu_name_power()}")
    check(len(jax.devices()) == 4,
          f"--four needs 4 devices, JAX sees {len(jax.devices())}")
    n = 4 * PAIRS
    host = corpus(0.05, n)
    runs = {}
    for cards in (4, 1):
        mesh = make_mesh(cards)
        step = make_sharded_pipeline(mesh, CFG)
        args = jax.block_until_ready(shard_batch(mesh, *host))
        t1 = time.perf_counter()
        jax.block_until_ready(step(*args))
        log(f"{cards} card(s): compile + first run "
            f"{time.perf_counter() - t1:.1f}s")
        ts = []
        for _ in range(3):
            t1 = time.perf_counter()
            out = jax.block_until_ready(step(*args))
            ts.append(time.perf_counter() - t1)
        runs[cards] = [np.asarray(o) for o in out]
        log(f"{cards} card(s), {n} pairs ({n // cards} per card): step "
            f"best {min(ts):.6f}s, runs {[round(t, 6) for t in ts]}")
        del args
    for name, a, b in zip(("nw", "greedy", "leap", "stats"), runs[4],
                          runs[1]):
        same = np.array_equal(a, b)
        log(f"{name}: four-card == one-card per pair: {same}")
        check(same, f"{name} differs between 4 cards and 1")
    log(f"stats (pairs, greedy==NW, leap==NW, leap passed, sums): "
        f"{runs[4][3].tolist()}")
    log(f"phase 7: {time.perf_counter() - t0:.1f}s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel phase")
    args = ap.parse_args()
    use_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX reports {devs[0].platform!r})")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log(describe(device))
    t0 = time.perf_counter()
    if args.four:
        four_cards()
    else:
        one_card()
    log(f"\nall phases passed in {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
