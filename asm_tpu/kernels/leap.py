"""Batched LEAP / Landau-Vishkin banded affine alignment.

Batched re-design of the reference's LV kernel
(GASMA/benchmark/LEAP_SIMD/LV_BAG.cpp, used by the headline benchmark via
benchmark_utils.h:156-179; the SIMD variant SIMD_ED.cpp computes the same
recurrence with AVX2 masks).

Wavefront state start/end/I_pos/D_pos is [B, TL] per energy level e
(TL = 2k+3 lanes incl. 2 sentinel border lanes, LV_BAG.cpp:78). One
jax.lax.while_loop iteration advances ALL pairs one energy level: lane-axis
shifts replace the l±1 reads, and the hot `count_ID_length` char-scan
(LV_BAG.cpp:9-23, the per-cell O(run) loop) becomes an O(1) gather into a
precomputed per-lane match-run structure (next_one_index over the LEAP
hurdle rows) — the same prefix-scan trick the SIMD code approximates with
shift+tzcnt (SIMD_ED.cpp:10-61).

A ring buffer of the last R = max(go, ge, ms)+1 energy rows replaces the
full [TL, E+1] history on the filter path; want_history=True widens the
ring to the full history for leap_backtrack (the benchmark path never
needs it — LEAP CIGARs are not scored, benchmark_utils.h:256).

Semantics follow asm_tpu.reference_impl.leap_ref (fresh per-pair state and
deterministic padding — see its docstring for the reference's state-leak
quirks that are deliberately NOT reproduced).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asm_tpu.config import AlignConfig, LeapMode
from asm_tpu.ops.packed import pack_rows, first_set_from
from asm_tpu.ops.hurdles import build_leap_lanes
from asm_tpu.utils.profiling import scoped

# plain ints (not jnp scalars): module import must not initialize the backend
UNREACHED = -2
BIG = 1 << 29


@functools.partial(
    jax.jit, static_argnames=("cfg", "want_history", "semantics",
                              "use_shd_gate")
)
@scoped("leap")
def leap_align(read_codes, read_len, ref_codes, ref_len, cfg: AlignConfig,
               want_history: bool = False, semantics: str = "lv_bag",
               use_shd_gate: bool = False):
    """Run LEAP on a batch.

    Returns dict(passed bool[B], penalty int32[B] (= af_threshold+1 when not
    passed), lane_shift int32[B] (final diagonal offset from mid)).

    With want_history=True additionally returns the full per-energy
    wavefront tables start/end/i_pos/d_pos as int32[B, af+1, TL] — the
    input to leap_backtrack (host-side CIGAR reconstruction, mirroring
    LV::backtrack LV_BAG.cpp:250-354). History costs 4*(af+1)*TL ints per
    pair; use small batches in CIGAR mode.

    semantics selects the reference kernel being mirrored (both share
    the wavefront; they differ in how the converged lane and reported
    ED are chosen):
      * "lv_bag" (default): LV_BAG.cpp — the benchmark's scalar kernel.
        GLOBAL/SEMI_FREE_BEGIN pick the minimum corrected energy among
        lanes converging at the same e; the reported penalty is the
        UNcorrected e.
      * "simd_ed_lev": SIMD_ED::run_levenshtein (SIMD_ED.cpp:269-353) —
        requires unit penalties and af == k (init_levenshtein's ED_t is
        both band and threshold). The run stops at the FIRST converged
        lane (lane order), and GLOBAL/SEMI_FREE_BEGIN report
        converge_ED = e + |lane - mid|, passing iff converge_ED <= k —
        so a pair can stop WITHOUT passing.
      * "simd_ed_affine": SIMD_ED::run_affine (SIMD_ED.cpp:488-616) —
        as lv_bag, but GLOBAL/SEMI_FREE_BEGIN report the CORRECTED
        converge_ED (get_ED, SIMD_ED.cpp:748-753); pairs that never
        pass (and pairs converging at e=0, which return before any
        correction) report the reset value 1000000 (SIMD_ED.cpp:485).
    SIMD_ED penalties mirror a FRESH kernel per pair; the reference
    object leaks state across pairs (see reference_impl.simd_ed_ref,
    whose run_pair flags affected pairs).

    use_shd_gate=True (simd_ed_lev only) fuses the reference's in-run
    SHD pre-filter (SIMD_ED.cpp:270 -> SHD.cpp:335-385) into this same
    jitted program: gated-out pairs are stopped before the wavefront
    with passed=False, penalty=0 (what a fresh SIMD_ED's get_ED
    returns after the early return). The affine gate is NOT offered —
    the reference's is undefined behavior (reads 2*SHD_threshold+1
    masks from a 2*k+3 array, SIMD_ED.cpp:489).
    """
    assert semantics in ("lv_bag", "simd_ed_lev", "simd_ed_affine")
    B, L = read_codes.shape
    k = cfg.k
    TL = cfg.leap_total_lanes
    mid = k + 1
    ms, go, ge = cfg.x, cfg.o, cfg.e
    af = cfg.leap_af_threshold
    mode = cfg.leap_mode
    corrected = mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN)
    if semantics != "lv_bag":
        assert not want_history, (
            "SIMD_ED CIGARs come from reference_impl.simd_ed_ref; the "
            "batched history path mirrors LV_BAG"
        )
    if semantics == "simd_ed_lev":
        assert (ms, go, ge) == (1, 1, 1) and af == k, (
            "init_levenshtein(ED_t): unit penalties, af_threshold == k"
        )
    if use_shd_gate:
        assert semantics == "simd_ed_lev", (
            "the reference gates run_levenshtein only (the affine gate "
            "is UB; lv_bag has no gate)"
        )
    # ring depth: backtracking needs the full energy history; the plain
    # filter path only the last max(go, ge, ms)+1 rows
    R = (af + 1) if want_history else max(go, ge, ms) + 1

    buflen = jnp.maximum(
        jnp.minimum(read_len, L), jnp.minimum(ref_len, L)
    ).astype(jnp.int32)  # benchmark_utils.h:162

    # bit-packed hurdle rows (uint32 words, asm_tpu.ops.packed): the hot
    # count_ID_length query becomes ctz/popcount word math instead of a
    # gather into a precomputed [B, TL, L+1] next-index table
    lanes = pack_rows(build_leap_lanes(read_codes, ref_codes, k) != 0)

    lane_ids = jnp.arange(TL, dtype=jnp.int32)
    interior = (lane_ids >= 1) & (lane_ids <= TL - 2)
    top = (lane_ids >= mid).astype(jnp.int32)  # LV_BAG.cpp:153-157
    bot = (lane_ids <= mid).astype(jnp.int32)
    lane_diff = jnp.abs(lane_ids - mid)

    def count_id(start):  # LV_BAG.cpp:9-23 as packed first-mismatch scan
        g = first_set_from(lanes, jnp.maximum(start, 0))
        run_end = jnp.minimum(g, buflen[:, None])
        return jnp.where(start >= buflen[:, None], start, run_end)

    # ---- e = 0 row (LV::init :95-105 + LV::run :131-147) ----
    if mode in (LeapMode.LOCAL, LeapMode.SEMI_FREE_BEGIN):
        start0 = jnp.broadcast_to(lane_diff[None, :], (B, TL)).astype(jnp.int32)
    else:
        start0 = jnp.where(lane_diff[None, :] == 0, 0, UNREACHED)
        start0 = jnp.broadcast_to(start0, (B, TL)).astype(jnp.int32)
    start0 = jnp.where(interior[None, :], start0, UNREACHED)
    end0 = jnp.where(start0 >= 0, count_id(start0), UNREACHED)

    conv0 = (end0 == buflen[:, None]) & (start0 >= 0) & interior[None, :]
    conv0_any = jnp.any(conv0, axis=1)
    if semantics == "lv_bag":
        # first converged lane in LV_BAG's scan order (LV_BAG.cpp:131-144)
        lane0 = jnp.argmax(conv0, axis=1).astype(jnp.int32)
    else:
        # SIMD_ED's scan order is mirrored vs this kernel's lane axis
        lane0 = (
            TL - 1 - jnp.argmax(jnp.flip(conv0, axis=1), axis=1)
        ).astype(jnp.int32)

    # an e=0 convergence bypasses every correction (SIMD_ED.cpp:287-291,
    # 509-513; LV_BAG.cpp:139-144), so all semantics pass on it; they
    # differ in the penalty a fresh kernel reports for it / by default
    if semantics == "simd_ed_affine" and corrected:
        pen0, default_pen = 1000000, 1000000  # reset_affine converge_ED
    elif corrected or semantics == "lv_bag":
        pen0, default_pen = 0, af + 1
    else:  # simd_ed fresh final_ED in LOCAL / SEMI_FREE_END modes
        pen0, default_pen = 0, 0
    passed0 = conv0_any
    stop0 = conv0_any
    if use_shd_gate:
        # the reference gates BEFORE the e=0 row (SIMD_ED.cpp:270): a
        # gated-out pair never runs, ED_pass=false, and a fresh object's
        # get_ED reads converge_ED == 0
        rc0 = jnp.where(read_codes < 4, read_codes, 0)
        fc0 = jnp.where(ref_codes < 4, ref_codes, 0)
        from asm_tpu.kernels.shd import shd_gate_masks

        gate_ok = shd_gate_masks(
            build_leap_lanes(rc0, fc0, k)[:, 1:-1, :], buflen, k
        )
        passed0 = passed0 & gate_ok
        stop0 = stop0 | ~gate_ok
        final_ed0 = jnp.where(
            ~gate_ok, 0, jnp.where(conv0_any, pen0, default_pen)
        ).astype(jnp.int32)
    else:
        final_ed0 = jnp.where(conv0_any, pen0, default_pen).astype(jnp.int32)

    # ring buffers: row r holds energy level e with e % R == r
    end_hist = jnp.full((B, R, TL), UNREACHED, jnp.int32)
    end_hist = end_hist.at[:, 0, :].set(end0)
    i_hist = jnp.full((B, R, TL), UNREACHED, jnp.int32)
    d_hist = jnp.full((B, R, TL), UNREACHED, jnp.int32)

    state = dict(
        e=jnp.int32(1),
        end_hist=end_hist,
        i_hist=i_hist,
        d_hist=d_hist,
        stop=stop0,
        passed=passed0,
        final_ed=final_ed0,
        final_lane=jnp.where(conv0_any, lane0, mid).astype(jnp.int32),
    )
    if want_history:
        start_hist = jnp.full((B, R, TL), UNREACHED, jnp.int32)
        state["start_hist"] = start_hist.at[:, 0, :].set(start0)

    def row(hist, e_idx):
        r = jnp.mod(e_idx, R)
        return jax.lax.dynamic_slice_in_dim(hist, r, 1, axis=1)[:, 0, :]

    def shift_up(a):  # value at lane l-1 (sentinel at l=0)
        return jnp.concatenate(
            [jnp.full((B, 1), UNREACHED, a.dtype), a[:, :-1]], axis=1
        )

    def shift_dn(a):  # value at lane l+1
        return jnp.concatenate(
            [a[:, 1:], jnp.full((B, 1), UNREACHED, a.dtype)], axis=1
        )

    def cond(s):
        return (s["e"] <= af) & jnp.any(~s["stop"])

    def body(s):
        e = s["e"]
        end_go = row(s["end_hist"], e - go)
        i_ge = row(s["i_hist"], e - ge)
        d_ge = row(s["d_hist"], e - ge)
        end_ms = row(s["end_hist"], e - ms)

        ok_go = e >= go
        ok_ge = e >= ge
        ok_ms = e >= ms

        end_up = jnp.where(ok_go, shift_up(end_go), UNREACHED)
        i_up = jnp.where(ok_ge, shift_up(i_ge), UNREACHED)
        i_new = jnp.where(
            (end_up >= 0) & (end_up > i_up),
            end_up + top[None, :],
            jnp.where(i_up >= 0, i_up + top[None, :], UNREACHED),
        )

        end_dn = jnp.where(ok_go, shift_dn(end_go), UNREACHED)
        d_dn = jnp.where(ok_ge, shift_dn(d_ge), UNREACHED)
        d_new = jnp.where(
            (end_dn >= 0) & (end_dn > d_dn),
            end_dn + bot[None, :],
            jnp.where(d_dn >= 0, d_dn + bot[None, :], UNREACHED),
        )

        s_ms = jnp.where(ok_ms & (end_ms >= 0), end_ms + 1, UNREACHED)
        start_new = jnp.maximum(s_ms, jnp.maximum(i_new, d_new))

        # border lanes are never written (LV_BAG.cpp:131 loops 1..TL-2)
        i_new = jnp.where(interior[None, :], i_new, UNREACHED)
        d_new = jnp.where(interior[None, :], d_new, UNREACHED)
        start_new = jnp.where(interior[None, :], start_new, UNREACHED)

        end_new = jnp.where(start_new >= 0, count_id(start_new), UNREACHED)

        conv = (end_new == buflen[:, None]) & (start_new >= 0) & interior[None, :]
        if semantics == "simd_ed_lev":
            # run_levenshtein breaks at the FIRST converged lane in ITS
            # scan order (SIMD_ED.cpp:333-346) — the pair STOPS whether or
            # not the converge correction passes it (SIMD_ED.cpp:349-352).
            # SIMD_ED's lane axis is MIRRORED vs this kernel's (its lane
            # i < mid shifts B — calculate_masks, SIMD_ED.cpp:194-201 —
            # where build_leap_lanes' lane < mid shifts A), so its first
            # scanned lane is our LAST: arg-last over conv.
            stop_now = jnp.any(conv, axis=1)
            lane_now = (
                TL - 1 - jnp.argmax(jnp.flip(conv, axis=1), axis=1)
            ).astype(jnp.int32)
            if corrected:
                onehot = lane_now[:, None] == lane_ids[None, :]
                ld_first = jnp.sum(
                    jnp.where(onehot, lane_diff[None, :], 0), axis=1
                )
                pen_now = e + ld_first  # converge_ED
                pass_now = stop_now & (pen_now <= af)
            else:
                pen_now = jnp.full_like(lane_now, 0) + e
                pass_now = stop_now
        elif corrected:
            t = e + jnp.where(lane_diff == 0, 0, go + (lane_diff - 1) * ge)
            tt = jnp.where(conv & (t[None, :] <= af), t[None, :], BIG)
            tmin = jnp.min(tt, axis=1)
            pass_now = tmin < BIG
            stop_now = pass_now
            if semantics == "simd_ed_affine":
                # strict `t < converge_ED` keeps the earliest lane in
                # SIMD_ED's scan order on ties (SIMD_ED.cpp:596) — the
                # LAST in this kernel's mirrored lane order (see above)
                lane_now = (
                    TL - 1 - jnp.argmin(jnp.flip(tt, axis=1), axis=1)
                ).astype(jnp.int32)
            else:
                lane_now = jnp.argmin(tt, axis=1).astype(jnp.int32)
            # LV_BAG reports the uncorrected energy (benchmark_utils.h:173);
            # SIMD_ED::get_ED reports converge_ED (SIMD_ED.cpp:748-753)
            pen_now = tmin if semantics == "simd_ed_affine" else (tmin * 0 + e)
        else:
            pass_now = jnp.any(conv, axis=1)
            stop_now = pass_now
            # LV_BAG.cpp:233-237 overwrites per lane -> LAST converged wins
            rev = jnp.flip(conv, axis=1)
            lane_now = (TL - 1 - jnp.argmax(rev, axis=1)).astype(jnp.int32)
            pen_now = jnp.full_like(lane_now, 0) + e

        fresh = stop_now & ~s["stop"]
        stop = s["stop"] | stop_now
        passed = s["passed"] | (pass_now & ~s["stop"])
        final_ed = jnp.where(fresh, pen_now, s["final_ed"])
        final_lane = jnp.where(fresh, lane_now, s["final_lane"])

        # freeze history rows of already-stopped pairs (they stop evolving)
        act = ~s["stop"]
        r = jnp.mod(e, R)

        def put(hist, new_row):
            old = jax.lax.dynamic_slice_in_dim(hist, r, 1, axis=1)[:, 0, :]
            new = jnp.where(act[:, None], new_row, old)
            return jax.lax.dynamic_update_slice_in_dim(
                hist, new[:, None, :], r, axis=1
            )

        out = dict(
            e=e + 1,
            end_hist=put(s["end_hist"], end_new),
            i_hist=put(s["i_hist"], i_new),
            d_hist=put(s["d_hist"], d_new),
            stop=stop,
            passed=passed,
            final_ed=final_ed,
            final_lane=final_lane,
        )
        if want_history:
            out["start_hist"] = put(s["start_hist"], start_new)
        return out

    s = jax.lax.while_loop(cond, body, state)
    out = dict(
        passed=s["passed"],
        penalty=s["final_ed"],
        lane_shift=s["final_lane"] - mid,
    )
    if want_history:
        out["start"] = s["start_hist"]
        out["end"] = s["end_hist"]
        out["i_pos"] = s["i_hist"]
        out["d_pos"] = s["d_hist"]
        out["final_lane_idx"] = s["final_lane"]
    return out
