"""CLI driver mirroring GASMA/benchmark/benchmark.cpp.

  python -m asm_tpu.bench                       # reference config sweep
  python -m asm_tpu.bench --pairs 100000 --err 0.05
  python -m asm_tpu.bench --file pairs.seq      # ">read\\n<ref\\n" file

The reference driver (benchmark.cpp:12-33) generates 5M-pair corpora at
err in {.05,.10,.15,.20}, caps at 1M alignments, penalties x=1,o=1,e=1,
band k=3.
"""

from __future__ import annotations

import argparse

from asm_tpu.bench.harness import run_benchmark, format_report
from asm_tpu.config import AlignConfig
from asm_tpu.data.generator import generate_dataset_arrays


def _gen(pairs, length, err, mr, seed, max_len, length_range=None,
         exact=True):
    """C++ generator when available (~50x faster for big corpora)."""
    from asm_tpu.native import generate_dataset_native, load_native

    if length_range is None and load_native() is not None:
        return generate_dataset_native(
            pairs, length, err, mr, seed=seed, max_len=max_len,
            exact_error_rate=exact,
        )
    return generate_dataset_arrays(
        pairs, length, err, mr, seed=seed, max_len=max_len,
        length_range=length_range, exact_error_rate=exact,
    )
from asm_tpu.data.io import read_pair_file
from asm_tpu.encoding import encode_batch


def main(argv=None):
    from asm_tpu.runtime import describe, require_device, use_compile_cache

    use_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", type=int, default=1_000_000)
    p.add_argument("--err", type=float, action="append", default=None,
                   help="error rate(s); default: 0.05 0.10 0.15 0.20")
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--mismatch-rate", type=float, default=0.96)
    p.add_argument("--file", type=str, default=None,
                   help="read pairs from a '>read/<ref' file instead")
    p.add_argument("--lt-eq", action="store_true",
                   help="draw each pair's error count uniformly in "
                        "[0, ceil(err*len)] instead of exactly ceil — "
                        "the reference's *_lt_eq corpora, where Greedy "
                        "scores 99.741%%/98.142%% accuracy at "
                        "err=0.05/0.10 (GASMA/benchmark/README.md)")
    p.add_argument("--real-profile", action="store_true",
                   help="use the SRR611076-profile synthetic corpus "
                        "(README.md:70-76 error rates) instead of the "
                        "WFA-style rate sweep")
    p.add_argument("--length-range", type=int, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="variable-length corpus: per-pair read lengths "
                        "uniform in [LO, HI] (the reference's real data "
                        "is variable-length; its MASK_END machinery "
                        "exists for this)")
    p.add_argument("--x", type=int, default=1)
    p.add_argument("--o", type=int, default=1)
    p.add_argument("--e", type=int, default=1)
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--chunk", type=int, default=1 << 20)
    p.add_argument("--coverage-sample", type=int, default=None,
               help="cap coverage to the first N pairs (default: full corpus, like the reference)")
    p.add_argument("--no-coverage", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    print(describe(require_device()), flush=True)

    cfg = AlignConfig(
        x=args.x, o=args.o, e=args.e, k=args.k, max_len=args.max_len
    )

    if args.file:
        reads, refs = read_pair_file(args.file, max_tests=args.pairs)
        corpora = [(f"file:{args.file}", encode_batch(reads, refs, cfg.max_len))]
    elif args.real_profile:
        from asm_tpu.data.generator import generate_real_profile_arrays

        lr = tuple(args.length_range) if args.length_range else None
        tag = f" lengths {lr[0]}-{lr[1]}" if lr else ""
        corpora = [(
            f"real-profile (SRR611076 rates){tag}",
            generate_real_profile_arrays(
                args.pairs, args.length, seed=args.seed,
                max_len=cfg.max_len, length_range=lr,
            ),
        )]
    else:
        errs = args.err or [0.05, 0.10, 0.15, 0.20]
        lr = tuple(args.length_range) if args.length_range else None
        tag = f" lengths {lr[0]}-{lr[1]}" if lr else ""
        if args.lt_eq:
            tag += " lt_eq"
        corpora = [
            (
                f"simulated err={e_:.2f}{tag}",
                _gen(args.pairs, args.length, e_, args.mismatch_rate,
                     args.seed, cfg.max_len, length_range=lr,
                     exact=not args.lt_eq),
            )
            for e_ in errs
        ]

    for name, (rc, rl, fc, fl) in corpora:
        print(f"--- {name}: {rc.shape[0]} pairs ---")
        r = run_benchmark(
            rc, rl, fc, fl, cfg,
            chunk=args.chunk,
            coverage_sample=0 if args.no_coverage else args.coverage_sample,
            want_coverage=not args.no_coverage,
        )
        print(format_report(r))


if __name__ == "__main__":
    main()
