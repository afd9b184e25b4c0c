"""Mapper core: FM-index candidates -> batched device rescoring -> SAM.

Candidate generation replaces SeqAn3's approximate `search(query, index,
max_error_total)` (mapper/main.cpp:67-77) with pigeonhole seeding: a read
with <= e errors split into e+1 seeds has at least one error-free seed, so
exact backward search of each seed finds every true location (plus decoys,
which batched rescoring eliminates — mirroring the reference's
hurdle_matrix rescoring of every hit, main.cpp:82-86).

Reference parity quirks kept deliberately:
  * window = ref[start .. start + |q| + 1] (main.cpp:79-80 span);
  * MAPQ = 60 + greedy cost (main.cpp:96 — the reference literally adds
    the penalty to 60);
  * hit_single_best: one best-cost record per read.
Improvement over the reference: the SAM CIGAR is the greedy kernel's real
CIGAR (the reference emits a FIXME'd dummy alignment, main.cpp:91).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from asm_tpu.config import AlignConfig
from asm_tpu.encoding import PAD_READ, PAD_REF
from asm_tpu.kernels.greedy import greedy_align
from asm_tpu.native import FMIndex


# jitted "finishers": every per-batch device output is combined into ONE
# pulled array inside a single compiled program, so the host pays one
# dispatch and one transfer instead of one per batch. Records are packed
# to uint16 on device (op in the 3 high bits, run in the 13 low — L <
# 8192 guaranteed), 5x fewer pulled bytes than the int8 ops + int32 runs.
_finish_costs = jax.jit(lambda costs, steps: (
    jnp.concatenate(costs), jnp.max(jnp.concatenate(steps))))


@functools.partial(jax.jit, static_argnames=("keep",))
def _finish_records(ops, runs, keep=None):
    """Concat + uint16-pack the per-batch record buffers; with `keep`
    (the phase-1-measured max step count, quantized), slice each buffer
    to its first 2*keep step slots plus the FINAL-LEAP pair that lives
    at the fixed tail positions (kernels/greedy.py slot layout) — the
    pulled bytes scale with the corpus's real step count, not the
    static bound."""
    def pack(o, r):
        p = (o.astype(jnp.uint16) << 13) | r.astype(jnp.uint16)
        if keep is not None and 2 * keep + 2 < p.shape[1]:
            p = jnp.concatenate([p[:, : 2 * keep], p[:, -2:]], axis=1)
        return p

    return jnp.concatenate([pack(o, r) for o, r in zip(ops, runs)])


def _unpack_records(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (packed >> 13).astype(np.int8), (packed & 0x1FFF).astype(np.int32)


def _pack_codes(codes: np.ndarray) -> np.ndarray:
    """Host-side 2-bit pack: [B, L] int8 codes -> [B, L/4] uint8 — 4x
    fewer host->device bytes (window uploads are the mapper's largest
    upload: 28 MB of int8 codes at 100k reads)."""
    c = codes.astype(np.uint8) & 3
    return (c[:, 0::4] | (c[:, 1::4] << 2)
            | (c[:, 2::4] << 4) | (c[:, 3::4] << 6))


def _unpack_codes(packed, lens, L: int, pad: int):
    """On-device inverse of _pack_codes, restoring the pad sentinel past
    each row's true length (cheap shifts vs 4x the transferred bytes)."""
    shifts = (jnp.arange(4, dtype=jnp.uint8) * 2)[None, None, :]
    c = ((packed[:, :, None] >> shifts) & 3).reshape(packed.shape[0], L)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(pos < lens[:, None], c.astype(jnp.int8),
                     jnp.int8(pad))


@functools.partial(jax.jit, static_argnames=("cfg", "want_cigar"))
def rescore(qp, ql, wp, wl, cfg: AlignConfig, want_cigar: bool = True):
    """The mapper's device step: a batch of 2-bit-PACKED reads and
    candidate windows (4x fewer host->device bytes than int8 codes) is
    unpacked on device and aligned by the greedy kernel."""
    L = qp.shape[1] * 4
    return greedy_align(_unpack_codes(qp, ql, L, PAD_READ), ql,
                        _unpack_codes(wp, wl, L, PAD_REF), wl, cfg,
                        want_cigar=want_cigar)


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    max_errors: int = 3          # pigeonhole seeds = max_errors + 1
    max_hits_per_seed: int = 16  # locate cap per seed range
    max_candidates: int = 64     # per read, after dedupe
    max_len: int = 128
    # max_steps=32 keeps the greedy record buffer at 66 slots instead of
    # 258 (the max_len default) — 4x less record traffic to pull; the
    # kernel's steps output is checked and map_reads transparently
    # re-runs with the provably-safe max_len bound if any pair would
    # truncate (never observed at mapper error budgets: cost p50 ~3)
    align: AlignConfig = AlignConfig(x=1, o=1, e=1, k=3, max_steps=32)
    batch: int = 4096            # rescoring launch size
    # None = auto: two-phase (cost-only scoring + winners-only CIGAR
    # pass) when the candidate fan-out exceeds ~2/read; at ~1
    # candidate/read the single packed-pull pass wins on every backend
    two_phase: bool | None = None


def build_index(ref_codes: np.ndarray, out_path: str | None = None) -> FMIndex:
    """Build (and optionally serialize) the FM-index over a reference
    (my-indexer, indexer.cpp:23-93)."""
    idx = FMIndex.build(np.ascontiguousarray(ref_codes, np.int8))
    if out_path:
        idx.save(out_path)
    return idx


def _candidates_batch(idx, read_codes, read_lens, mcfg: MapperConfig):
    """Pigeonhole candidate starts for the whole batch: ONE native call
    (asm_fm_candidates) instead of per-seed ctypes round-trips; seeds
    whose SA range exceeds max_hits_per_seed are evenly SAMPLED across
    the range — a true site in a repeat region stays reachable where a
    silent skip would lose it (cf. SeqAn3 enumerating every hit,
    mapper/main.cpp:67-77)."""
    return idx.candidates_batch(
        read_codes,
        read_lens,
        max_errors=mcfg.max_errors,
        max_hits_per_seed=mcfg.max_hits_per_seed,
        max_candidates=mcfg.max_candidates,
    )


def map_reads(
    idx: FMIndex,
    ref_codes: np.ndarray,
    read_codes: np.ndarray,
    read_lens: np.ndarray,
    read_names: list[str] | None = None,
    mcfg: MapperConfig | None = None,
    ref_name: str = "ref",
    profile: dict | None = None,
):
    """Map a read batch; returns a list of SAM record dicts (best hit per
    read; None entries for unmapped reads) and the SAM text.

    Pass ``profile={}`` to receive a per-stage wall-clock breakdown
    (seconds): candidates / assemble+dispatch / pull / select / cigar /
    sam, plus job counts — the evidence trail for where mapper time goes
    on a given backend.
    """
    import time

    mcfg = mcfg or MapperConfig()
    prof = profile if profile is not None else {}
    n_reads, L = read_codes.shape
    assert L < 8192, "record packing uses 13-bit runs"
    assert L % 4 == 0, "2-bit code packing needs L % 4 == 0"
    ref_len_total = ref_codes.shape[0]

    align_fn = functools.partial(rescore, cfg=mcfg.align)
    # phase-1 scoring pulls ONLY the cost vector (plus the steps array,
    # kept device-side for the truncation guard): the kernel then writes
    # no CIGAR records and phase-1 device->host traffic is 4 B/candidate
    cost_fn = jax.jit(
        lambda a, b, c, d: (lambda r: (r["cost"], r["steps"]))(
            rescore(a, b, c, d, cfg=mcfg.align, want_cigar=False))
    )

    # gather candidate (read, window) pairs — one native call per batch;
    # the job list, window assembly and best-hit selection are all
    # vectorized numpy (a per-candidate Python loop dominated wall time
    # at scale long before the device did)
    t0 = time.perf_counter()
    starts, counts = _candidates_batch(idx, read_codes, read_lens, mcfg)
    mask = np.arange(starts.shape[1])[None, :] < counts[:, None]
    jobs_ri, jobs_t = np.nonzero(mask)
    jobs_start = starts[jobs_ri, jobs_t].astype(np.int64)
    nj = jobs_ri.size
    prof["candidates_s"] = time.perf_counter() - t0
    prof["n_jobs"] = int(nj)

    colv = np.arange(L, dtype=np.int64)
    rlens = read_lens.astype(np.int64)

    def assemble(bri, bst):
        """Padded [batch, L/4] PACKED (q, ql, w, wl) arrays for a job
        slice (window = read_len + 1, main.cpp:79-80); every launch has
        the SAME shape so each kernel compiles exactly once. Content
        past a row's length (incl. all-zero pad rows: length 0) is
        restored to the pad sentinel by the on-device unpack."""
        bs = bri.size
        padded = mcfg.batch
        qp = np.zeros((padded, L // 4), np.uint8)
        ql = np.zeros(padded, np.int32)
        wp = np.zeros((padded, L // 4), np.uint8)
        wl = np.zeros(padded, np.int32)
        qp[:bs] = _pack_codes(read_codes[bri])
        ql[:bs] = read_lens[bri]
        span = np.minimum(np.minimum(rlens[bri] + 1,
                                     ref_len_total - bst), L)
        # window gather + pack in one threaded native pass (numpy
        # fancy-gather fallback when the library is unavailable)
        from asm_tpu.native import window_pack_native

        if window_pack_native(ref_codes, bst, span.astype(np.int32), L,
                              out=wp[:bs]) is None:
            win = ref_codes[np.minimum(bst[:, None] + colv[None, :],
                                       ref_len_total - 1)]
            wp[:bs] = _pack_codes(win)
        wl[:bs] = span
        return (jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(wp),
                jnp.asarray(wl))

    # strategy (mcfg.two_phase=None = auto): cost-only scoring + a
    # winners-only CIGAR pass when the candidate fan-out exceeds
    # ~2/read (repeat-heavy genomes, large max_candidates). At ~1
    # candidate/read the single pass wins on every backend now that
    # records ride ONE packed uint16 pull (132 B/candidate): the
    # two-phase variant would re-upload + re-align every winner to
    # save pulled bytes it no longer pays for
    two_phase = mcfg.two_phase
    if two_phase is None:
        two_phase = nj > 2 * n_reads
    prof["two_phase"] = bool(two_phase)

    big = np.iinfo(np.int64).max
    best_cost = np.full(n_reads, big, np.int64)
    best_pos = np.zeros(n_reads, np.int64)
    best_rec = None  # packed uint16 winner records [n_mapped, C]
    mapped = np.zeros(0, np.int64)
    if nj:
        # phase 1 — dispatch EVERY scoring batch before pulling any
        # result: the device queue pipelines the kernels against the
        # host-side window assembly, and the pull latency is paid once
        # instead of per batch
        phase1 = cost_fn if two_phase else align_fn
        t0 = time.perf_counter()
        outs = []
        for base in range(0, nj, mcfg.batch):
            sel = slice(base, min(base + mcfg.batch, nj))
            outs.append(phase1(*assemble(jobs_ri[sel], jobs_start[sel])))
        prof["p1_assemble_dispatch_s"] = time.perf_counter() - t0
        prof["p1_batches"] = len(outs)

        # ONE jitted device-side concat + ONE host pull for the whole
        # corpus (batches are padded to mcfg.batch, so concat row
        # i*batch+j is exactly global job i*batch+j: [:nj] is job order,
        # pad rows are all at the tail)
        t0 = time.perf_counter()
        cat, max_steps = _finish_costs(
            [o[0] if two_phase else o["cost"] for o in outs],
            [o[1] if two_phase else o["steps"] for o in outs])
        costs = np.asarray(cat)[:nj].astype(np.int64)
        max_steps = int(np.asarray(max_steps))
        prof["p1_pull_s"] = time.perf_counter() - t0
        if (max_steps >= mcfg.align.steps_bound
                and mcfg.align.max_steps is not None):
            # a pair would truncate at the tight mapper bound —
            # transparently redo with the provably-safe max_len bound
            # (a highway step always advances >= 1 column)
            fallback = dataclasses.replace(
                mcfg, align=dataclasses.replace(mcfg.align,
                                                max_steps=None))
            return map_reads(idx, ref_codes, read_codes, read_lens,
                             read_names, fallback, ref_name, profile)

        # per-read minimum with the original first-candidate-wins tie
        # break: stable (read, cost, order) sort, keep each read's
        # first row — one global vectorized pass
        t0 = time.perf_counter()
        order = np.lexsort((np.arange(nj), costs, jobs_ri))
        keep = np.ones(nj, bool)
        sri = jobs_ri[order]
        keep[1:] = sri[1:] != sri[:-1]
        rows = order[keep]
        best_cost[jobs_ri[rows]] = costs[rows]
        best_pos[jobs_ri[rows]] = jobs_start[rows]
        mapped = np.nonzero(best_cost < big)[0]
        prof["select_s"] = time.perf_counter() - t0

        winner_rows = None
        if two_phase:
            # phase 2 — CIGARs for the winning placements only; again
            # all batches dispatched, then one concat + packed pull
            t0 = time.perf_counter()
            outs_rec = []
            for base in range(0, mapped.size, mcfg.batch):
                bri = mapped[base: base + mcfg.batch]
                outs_rec.append(align_fn(*assemble(bri, best_pos[bri])))
            prof["p2_assemble_dispatch_s"] = time.perf_counter() - t0
            prof["p2_batches"] = len(outs_rec)
        else:
            # single pass kept the records; pull them all and keep the
            # winner rows (CPU backend: the "pull" is a memcpy)
            outs_rec = outs
            winner_rows = np.full(n_reads, -1, np.int64)
            winner_rows[jobs_ri[rows]] = rows
        t0 = time.perf_counter()
        # quantizing the measured step count to a multiple of 4 keeps
        # the set of compiled slicer programs small across corpora
        keep_steps = max(4, -(-max_steps // 4) * 4)
        packed = _finish_records(
            [o["cigar_ops"] for o in outs_rec],
            [o["cigar_runs"] for o in outs_rec],
            keep=keep_steps)
        prof["rec_dispatch_s"] = time.perf_counter() - t0

    # overlap the record pull (GIL released while the transfer drains)
    # with the SAM sequence decode (pure host work)
    from concurrent.futures import ThreadPoolExecutor

    rec_fut = None
    pool = None
    if mapped.size:
        pool = ThreadPoolExecutor(1)
        rec_fut = pool.submit(np.asarray, packed)

    t0 = time.perf_counter()
    names = read_names or [f"read{i}" for i in range(n_reads)]
    from asm_tpu.encoding import decode_batch

    seqs = decode_batch(read_codes, read_lens)
    prof["sam_seqs_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    best = [None] * n_reads
    if mapped.size:
        from asm_tpu.native import cigar_strings_packed

        packed_h = rec_fut.result()
        pool.shutdown()
        prof["rec_pull_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if winner_rows is None:
            best_rec = packed_h[: mapped.size]
        else:
            best_rec = packed_h[:nj][winner_rows[mapped]]
        cigars = cigar_strings_packed(best_rec)
        for mi, ri in enumerate(mapped):
            c = int(best_cost[ri])
            best[ri] = dict(
                read=int(ri),
                pos=int(best_pos[ri]),
                cost=c,
                cigar=cigars[mi],
                mapq=60 + c,  # reference quirk, main.cpp:96
            )
    prof["cigar_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lines = [
        "@HD\tVN:1.6\tSO:unknown",
        f"@SQ\tSN:{ref_name}\tLN:{ref_len_total}",
        "@PG\tID:asm_tpu\tPN:asm_tpu-mapper",
    ]
    for ri in range(n_reads):
        b = best[ri]
        if b is None:
            lines.append(
                f"{names[ri]}\t4\t*\t0\t0\t*\t*\t0\t0\t{seqs[ri]}\t*"
            )
        else:
            lines.append(
                f"{names[ri]}\t0\t{ref_name}\t{b['pos'] + 1}\t{b['mapq']}\t"
                f"{b['cigar'] or '*'}\t*\t0\t0\t{seqs[ri]}\t*"
            )
    prof["sam_s"] = time.perf_counter() - t0
    return best, "\n".join(lines) + "\n"
