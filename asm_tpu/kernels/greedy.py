"""Batched GASMA greedy hurdle-matrix highway alignment (the flagship).

One Pallas kernel, compiled by Triton for NVIDIA GPUs, re-designs
GASMA/hurdle_matrix.h for a whole batch of pairs. It fuses the per-pair
pipeline — hurdle-row construction from 2-bit planes, morphological
denoise (flip_short_hurdles(1), hurdle_matrix.h:453) and the greedy
highway loop — so nothing but the planes, the lengths and the results
crosses device memory. Semantics are those of the scalar emulator
asm_tpu.reference_impl.greedy_ref (see its docstring for the reference
quirks reproduced, the sentinel-padding deviation, and the float32
heuristic ties that can break either way on extreme-error pairs).

Layout: one pair per vector element. A program aligns BLOCK pairs; every
per-pair scalar is a [BLOCK] vector and every hurdle-lane word a [BLOCK]
uint32 vector (NL lanes x W words per pair, unrolled statically), so the
packed rows stay in registers for the whole walk. first_zero / first_one /
pop_count_between (GASMA/utils.h:168-270) are ctz/popcount word math. The
loop state is the while_loop carry, and each program's loop exits when ITS
OWN pairs are done, so a hard pair costs one block, not the whole batch.

Inputs are position-major 2-bit planes uint32[2Wp, B] (row w = code bit 0
of positions 32w..32w+31, row W+w = code bit 1; Wp pads W to a power of
two for the block shape), packed by XLA in the wrapper. There is no
validity plane: by the encoding contract (encoding.py) sentinels start
exactly at the true length, so "position invalid" is the closed-form
length mask mask_ge(len - shift).

CIGAR step records leave as one packed int per step — bit 0 flags the
final leap, bits 1-7 carry the in-loop lane delta biased by +64, bits 8+
the match advance — and are expanded to (op, run) slot buffers in XLA:
slot 2t is step t's leap (I if it moved down a lane, else D), slot 2t+1
its merged match-or-mismatch 'M' run, the last two slots the final leap
(hurdle_matrix.h:238-251 appends the same ops to a string). The final
leap's lane delta spans +-(L+k) (out-of-band destinations), so the
expansion reconstructs it as dest_lane - sum(in-loop deltas). Op codes:
3 'I', 4 'D', 5 'M'; slots with run 0 are empty.

On a GPU the kernel is compiled (`backend="triton"`); on any other
backend the same kernel body runs in Pallas interpret mode, which is how
the CPU tests reach it. Configurations it does not support raise
(`check_supported`); there is no second implementation to fall back to.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from asm_tpu.config import AlignConfig, AlignmentType

OP_M = 5
OP_I = 3
OP_D = 4

# pairs per program and warps per program: one pair per thread keeps the
# packed rows (2 * NL * W words) in registers. 64/2 measured fastest of
# 32/1, 64/2, 128/2, 128/4 and 256/4 at 1M pairs, err 0.05 and 0.20
# (H100 80GB HBM3, 400 W limit; PERF.md)
BLOCK = 64
NUM_WARPS = 2
FULL = 0xFFFFFFFF


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _rec_dtype(cfg: AlignConfig):
    """int16 step records when the fields fit (flag 1 bit, in-loop lane
    delta + 64 in 7 bits, advance in 8); int32 otherwise."""
    if cfg.max_len <= 255 and 2 * cfg.k <= 62:
        return jnp.int16
    return jnp.int32


def check_supported(cfg: AlignConfig) -> None:
    """Raise for configurations the kernel does not implement."""
    if cfg.max_len % 32:
        raise ValueError(
            f"greedy_align needs max_len % 32 == 0, got {cfg.max_len}")
    if cfg.flip_threshold != 1:
        raise NotImplementedError(
            "greedy_align supports flip_threshold=1 (the reference's "
            "value) only")
    if 2 * cfg.k > 62:
        raise NotImplementedError(
            f"greedy_align records lane deltas in 7 bits (k <= 31), "
            f"got k={cfg.k}")


def _popc(w):
    """popcount of uint32 words. Triton lowers the signed form to the
    card's popc instruction and has no rule for the unsigned one, so the
    words are reinterpreted as int32 first (same bits)."""
    return jax.lax.population_count(w.astype(jnp.int32))


def _ctz32(w):
    low = w & (~w + jnp.uint32(1))
    return _popc(low - jnp.uint32(1))


def _greedy_kernel(cfg: AlignConfig, want_rec: bool, rp_ref, fp_ref, rl_ref,
                   fl_ref, cost_ref, steps_ref, *rec):
    k = cfg.k
    NL = cfg.num_lanes
    L = cfg.max_len
    W = L // 32
    x, o, e = cfg.x, cfg.o, cfg.e
    is_global = cfg.alignment_type == AlignmentType.GLOBAL
    match_sig, mismatch_sig, indel_sig = cfg.significance
    T = cfg.steps_bound
    rec_ref = rec[0] if want_rec else None
    rec_dt = _rec_dtype(cfg)

    m = jnp.minimum(rl_ref[...], L)
    n = jnp.minimum(fl_ref[...], L)
    shape = m.shape
    zero = jnp.zeros(shape, jnp.int32)
    zero_u = jnp.zeros(shape, jnp.uint32)

    def mask_ge(c, w):
        low = jnp.clip(c - 32 * w, 0, 32)
        msk = jnp.uint32(FULL) << jnp.minimum(low, 31).astype(jnp.uint32)
        return jnp.where(low >= 32, jnp.uint32(0), msk)

    def masks_ge(c):
        return [mask_ge(c, w) for w in range(W)]

    r_pl = ([rp_ref[w] for w in range(W)], [rp_ref[W + w] for w in range(W)])
    f_pl = ([fp_ref[w] for w in range(W)], [fp_ref[W + w] for w in range(W)])

    # ---- hurdle rows (_construct_hurdles, hurdle_matrix.h:441-455) ------
    # Per lane one side's planes are funnel-shifted toward position 0 by
    # |lane| bits; hurdle = (bit0 differ) | (bit1 differ) | invalid, with
    # invalid(s) = mask_ge(len - s) built as a chain: inv(s) is inv(s-1)
    # shifted down one bit with the top bit refilled (bit L-1 is always
    # invalid at s >= 1).
    def inv_chain(base_len):
        out = [masks_ge(base_len)]
        for _ in range(k):
            prev = out[-1]
            out.append([
                (prev[w] >> jnp.uint32(1))
                | ((prev[w + 1] << jnp.uint32(31)) if w + 1 < W
                   else jnp.uint32(0x80000000))
                for w in range(W)
            ])
        return out

    inv_r = inv_chain(m)
    inv_f = inv_chain(n)

    def funnel(words, s):
        """Shift a packed row toward position 0: bit p = input bit p+s."""
        if s == 0:
            return words
        return [
            (words[w] >> jnp.uint32(s))
            | ((words[w + 1] << jnp.uint32(32 - s)) if w + 1 < W else zero_u)
            for w in range(W)
        ]

    orig = []  # [NL][W]
    for lane in range(-k, k + 1):
        a_off, b_off = max(-lane, 0), max(lane, 0)
        a0, a1 = (funnel(p, a_off) for p in r_pl)
        b0, b1 = (funnel(p, b_off) for p in f_pl)
        orig.append([
            (a0[w] ^ b0[w]) | (a1[w] ^ b1[w]) | inv_r[a_off][w]
            | inv_f[b_off][w]
            for w in range(W)
        ])

    # ---- denoise: flip_short_hurdles(1) (hurdle_matrix.h:453) ------------
    den = []
    for h in orig:
        words = []
        for w in range(W):
            lo_prev = h[w - 1] >> jnp.uint32(31) if w > 0 else zero_u
            hi_next = h[w + 1] << jnp.uint32(31) if w < W - 1 else zero_u
            near = (h[w] << jnp.uint32(1)) | lo_prev | (h[w] >> jnp.uint32(1)) \
                | hi_next
            words.append(h[w] & near)
        den.append(words)

    def count_range(words, lo, hi, lo_masks=None):
        """popcount in [lo, hi); lo_masks=None with lo=None means lo = 0."""
        cnt = zero
        for w in range(W):
            msk = ~mask_ge(hi, w)
            if lo_masks is not None:
                msk = msk & lo_masks[w]
            elif lo is not None:
                msk = msk & mask_ge(lo, w)
            cnt = cnt + _popc(words[w] & msk)
        return cnt

    def sfc(l1, l2):  # switch_forward_column (GASMA/utils.h:587-593)
        a1, a2 = jnp.abs(l1), jnp.abs(l2)
        return jnp.where(l1 * l2 >= 0, jnp.maximum(a1 - a2, 0), a1)

    def slp(l1, l2):  # switch_lane_penalty (GASMA/utils.h:576-579)
        d = jnp.abs(l1 - l2)
        return jnp.where(d == 0, 0, o + e * (d - 1))

    # ---- per-lane destinations (_calculate_destination) -----------------
    dest = []
    ge = m >= n
    for lane in range(-k, k + 1):
        dest_ge = n - lane if lane > 0 else jnp.where(lane >= n - m, n,
                                                      m + lane)
        dest_lt = m + lane if lane < 0 else jnp.where(lane <= n - m, m,
                                                      n - lane)
        dest.append(jnp.where(ge, dest_ge, dest_lt))
    dest_lane = n - m
    in_band = jnp.abs(dest_lane) <= k

    def step(state, first):
        """One highway step (_update_highway_list, _choose_best_highway,
        _step; hurdle_matrix.h:285-434). `first` peels iteration 0, whose
        state is static (lane 0, column 0, empty cache), so its masks and
        selects fold at trace time."""
        cur_lane, cur_col, cost, done, steps, sp, hlen, nsw = state
        act = done == 0

        start_col, sc_masks = [], []
        sp_n, hlen_n, nsw_n = [None] * NL, [None] * NL, [None] * NL
        reaching = jnp.zeros(shape, jnp.bool_)
        for li in range(NL):
            lane = li - k
            if first:
                sc = zero
                sc_masks.append(None)
                u = den[li]
            else:
                sc = cur_col + sfc(cur_lane, lane)
                rc_ = (sp[li] < sc) & act
                mge_sc = masks_ge(sc)
                sc_masks.append(mge_sc)
                # u = den with every bit below sc forced to 1: its trailing
                # ones run through fz-1, so u & (u+1) is den restricted to
                # bits > fz — first_zero and the next first_one in one pass
                u = [den[li][w] | ~mge_sc[w] for w in range(W)]
            fz = jnp.full(shape, L, jnp.int32)
            for w in range(W):
                nu = ~u[w]
                fz = jnp.minimum(fz, jnp.where(nu == 0, L, 32 * w + _ctz32(nu)))
            carry = jnp.ones(shape, jnp.uint32)
            no_g = jnp.full(shape, L, jnp.int32)
            for w in range(W):
                s_w = u[w] + carry
                carry = carry & (s_w == 0).astype(jnp.uint32)
                v_w = u[w] & s_w
                no_g = jnp.minimum(no_g,
                                   jnp.where(v_w == 0, L, 32 * w + _ctz32(v_w)))
            sp_new = fz if first else jnp.where(sc > L, sc, fz)
            raw_len = jnp.where((sp_new >= L) | (no_g >= L), L, no_g - sp_new)
            clamp = sp_new + raw_len > dest[li]
            len_new = jnp.where(clamp, jnp.maximum(dest[li] - sp_new, 0),
                                raw_len)
            if first:
                sp_n[li] = sp_new
                hlen_n[li] = len_new
                nsw_n[li] = jnp.full(shape, abs(lane), jnp.int32)
                reaching = reaching | clamp
            else:
                sp_n[li] = jnp.where(rc_, sp_new, sp[li])
                hlen_n[li] = jnp.where(rc_, len_new, hlen[li])
                nsw_n[li] = jnp.where(rc_, jnp.abs(lane - cur_lane), nsw[li])
                reaching = reaching | (rc_ & clamp)
            start_col.append(sc)

        swc, hc, nhur = [], [], []
        for li in range(NL):
            lane = li - k
            if first:
                # the semi-global first step switches lanes for free
                pen = 0 if lane == 0 else o + e * (abs(lane) - 1)
                sc_pen = zero + (pen if is_global else 0)
            else:
                sc_pen = slp(cur_lane, lane)
            nh = count_range(orig[li], None, sp_n[li] + hlen_n[li],
                             lo_masks=sc_masks[li])
            swc.append(sc_pen)
            nhur.append(nh)
            hc.append(x * nh)

        # selection scan (hurdle_matrix.h:325-352): sequential arg-max
        best_h = jnp.full(shape, -jnp.inf, jnp.float32)
        best_lh = jnp.full(shape, -(2.0**31), jnp.float32)
        best_li = zero
        for li in range(NL):
            lane = li - k
            sig = (match_sig * hlen_n[li].astype(jnp.float32)
                   + mismatch_sig * nhur[li].astype(jnp.float32)
                   + indel_sig * nsw_n[li].astype(jnp.float32))
            fsc = slp(lane, dest_lane) if is_global else zero
            h_reach = (-(swc[li] + hc[li]) - fsc
                       - x * (dest[li] - sp_n[li] - hlen_n[li])
                       ).astype(jnp.float32)
            h = jnp.where(reaching, h_reach, sig)
            lh = (-swc[li] - jnp.where(reaching, fsc, 0)).astype(jnp.float32)
            better = (h > best_h) | ((h == best_h) & (lh > best_lh))
            best_h = jnp.where(better, h, best_h)
            best_lh = jnp.where(better, lh, best_lh)
            best_li = jnp.where(better, li, best_li)

        def pick(vals, idx):
            out = vals[0]
            for li in range(1, NL):
                out = jnp.where(idx == li, vals[li], out)
            return out

        valid = pick(hlen_n, best_li) > 0

        # _choose_best_highway (hurdle_matrix.h:368-401)
        best_lane_v = best_li - k
        sp_b = pick(sp_n, best_li)
        row_b = [pick([orig[li][w] for li in range(NL)], best_li)
                 for w in range(W)]
        stc = pick(swc, best_li) + pick(hc, best_li)
        sic = stc
        bil = best_li
        hi_b = [~mask_ge(sp_b, w) for w in range(W)]
        for li in range(NL):
            lane = li - k
            fwd_lb = sfc(lane, best_lane_v)
            skip = (best_li == li) | (sp_n[li] + fwd_lb > sp_b)
            # the reference adds the RAW popcount here (hurdle_matrix.h:389)
            ic = swc[li] + nhur[li]
            lo = fwd_lb + sp_n[li] + hlen_n[li]
            cross = zero
            for w in range(W):
                cross = cross + _popc(row_b[w] & mask_ge(lo, w) & hi_b[w])
            tc = ic + slp(lane, best_lane_v) + jnp.maximum(0, x * cross)
            upd = ~skip & (tc <= stc) & (ic <= sic)
            stc = jnp.where(upd, tc, stc)
            sic = jnp.where(upd, ic, sic)
            bil = jnp.where(upd, li, bil)

        # commit the step (_step, hurdle_matrix.h:407-434)
        bl_lane = bil - k
        sp_c = pick(sp_n, bil)
        len_c = pick(hlen_n, bil)
        move = valid if first else act & valid
        cost = cost + jnp.where(move, pick(swc, bil) + pick(hc, bil), 0)
        distance = sp_c + len_c - (cur_col + sfc(cur_lane, bl_lane))
        dl = bl_lane - cur_lane
        record = jnp.where(move, ((dl + 64) << 1) | (distance << 8), 0)

        new_lane = jnp.where(move, bl_lane, cur_lane)
        new_col = jnp.where(move, sp_c + len_c, cur_col)
        dest_new = pick(dest, new_lane + k)
        done_b = (~act) | (act & ~valid) | (move & (new_col >= dest_new))
        new_state = (new_lane, new_col, cost, done_b.astype(jnp.int32),
                     steps + move.astype(jnp.int32), tuple(sp_n),
                     tuple(hlen_n), tuple(nsw_n))
        return new_state, record

    def store_rec(row, vals):
        if want_rec:
            rec_ref[row] = vals.astype(rec_dt)

    init = (zero, zero, zero, zero, zero, (zero,) * NL, (zero,) * NL,
            (zero,) * NL)
    if T >= 1:
        state, record = step(init, True)
        store_rec(0, record)

        def cond(c):
            it, st = c
            return (it < T) & (jnp.max(1 - st[3]) > 0)

        def body(c):
            it, st = c
            st, record = step(st, False)
            store_rec(it, record)
            return it + 1, st

        it, state = jax.lax.while_loop(cond, body, (jnp.int32(1), state))
    else:
        it, state = jnp.int32(0), init
    cur_lane, cur_col, cost, _, steps = state[:5]

    # ---- final leap to the destination (run(), hurdle_matrix.h:574-590) --
    dl_c = jnp.clip(dest_lane, -k, k)
    dest_col = zero
    row_dl = [zero_u] * W
    for li in range(NL):
        sel = dl_c + k == li
        dest_col = jnp.where(sel, dest[li], dest_col)
        row_dl = [jnp.where(sel, orig[li][w], row_dl[w]) for w in range(W)]
    lo = cur_col + sfc(cur_lane, dest_lane)
    distance = jnp.where(in_band, count_range(row_dl, lo, dest_col), 0)
    moved_off = cur_lane != dest_lane
    needs = jnp.where(in_band, moved_off | (cur_col < dest_col), moved_off)
    sc_pen = slp(cur_lane, dest_lane) if is_global else zero
    cost = cost + jnp.where(needs, sc_pen + jnp.maximum(0, x * distance), 0)

    cost_ref[...] = cost
    steps_ref[...] = steps
    if want_rec:
        store_rec(it, jnp.where(needs,
                                1 | (jnp.where(distance > 0, distance, 0) << 8),
                                0))
        # rows past the final record stay empty (they decode to no slots)
        rows = rec_ref.shape[0]

        def fill(r, carry):
            rec_ref[r] = jnp.zeros(shape, rec_dt)
            return carry

        jax.lax.fori_loop(it + 1, rows, fill, 0)


def pack_planes(codes, max_len: int):
    """int8 codes [B, L] -> position-major 2-bit planes uint32[2Wp, B]:
    row w = code bit 0 of positions 32w..32w+31 (bit p = position 32w+p),
    row W+w = code bit 1; rows past 2W are zero padding (Wp = pow2(2W)/2).
    Sentinel codes lose their meaning here: validity comes from lengths."""
    B, L = codes.shape
    if L != max_len:
        raise ValueError(f"codes have {L} columns, cfg.max_len is {max_len}")
    W = L // 32
    c = codes.astype(jnp.uint32).reshape(B, W, 32)
    weights = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    p0 = jnp.sum((c & 1) * weights, axis=-1, dtype=jnp.uint32)
    p1 = jnp.sum(((c >> 1) & 1) * weights, axis=-1, dtype=jnp.uint32)
    planes = jnp.concatenate([p0, p1], axis=1)  # [B, 2W]
    rows = _pow2(2 * W)
    if rows > 2 * W:
        planes = jnp.pad(planes, ((0, 0), (0, rows - 2 * W)))
    return planes.T


@functools.partial(jax.jit, static_argnames=("cfg", "want_cigar"))
def greedy_align(read_codes, read_len, ref_codes, ref_len, cfg: AlignConfig,
                 want_cigar: bool = True):
    """Greedy highway alignment over a batch.

    Args:
      read_codes/ref_codes: int8[B, max_len] sentinel-padded 2-bit codes.
      read_len/ref_len: int32[B].
      cfg: AlignConfig (k, x, o, e, alignment_type, priors, max_steps);
        see `check_supported` for what the kernel takes.
      want_cigar: also return the CIGAR slot buffers.

    Returns dict with:
      cost: int32[B] total penalty (hurdle_matrix.h get_cost :677)
      steps: int32[B] number of highway steps taken
      and, with want_cigar,
      cigar_ops / cigar_runs: int8/int32 [B, 2T+2] fixed-slot buffers
        (T = cfg.steps_bound; slots with run == 0 are empty)
      cigar_count: int32[B] number of non-empty slots
    """
    check_supported(cfg)
    L = cfg.max_len
    T = cfg.steps_bound
    B = read_codes.shape[0]
    BP = B + (-B) % BLOCK
    pad = BP - B
    rl = read_len.astype(jnp.int32)
    fl = ref_len.astype(jnp.int32)
    rc, fc = read_codes, ref_codes
    if pad:
        rc = jnp.pad(rc, ((0, pad), (0, 0)))
        fc = jnp.pad(fc, ((0, pad), (0, 0)))
        rl = jnp.pad(rl, (0, pad))
        fl = jnp.pad(fl, (0, pad))
    rp = pack_planes(rc, L)
    fp = pack_planes(fc, L)
    rows = rp.shape[0]
    TP = _pow2(T + 1)

    vec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    planes_spec = pl.BlockSpec((rows, BLOCK), lambda i: (0, i))
    out_specs = [vec, vec]
    out_shape = [jax.ShapeDtypeStruct((BP,), jnp.int32)] * 2
    if want_cigar:
        out_specs.append(pl.BlockSpec((TP, BLOCK), lambda i: (0, i)))
        out_shape.append(jax.ShapeDtypeStruct((TP, BP), _rec_dtype(cfg)))

    def kernel(interpret):
        return pl.pallas_call(
            functools.partial(_greedy_kernel, cfg, want_cigar),
            grid=(BP // BLOCK,),
            in_specs=[planes_spec, planes_spec, vec, vec],
            out_specs=out_specs,
            out_shape=out_shape,
            backend="triton",
            compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                     num_stages=1),
            interpret=interpret,
            name="greedy_align",
        )

    with jax.named_scope("greedy"):
        # chosen by the platform the program is lowered for: compiled on
        # CUDA, interpreted elsewhere
        outs = jax.lax.platform_dependent(
            rp, fp, rl, fl, cuda=kernel(False), default=kernel(True))
    cost = outs[0][:B]
    steps = outs[1][:B]
    if not want_cigar:
        return dict(cost=cost, steps=steps)

    # ---- expand packed records to (op, run) slot buffers ----------------
    r = outs[2][:T + 1, :B].astype(jnp.int32)
    if _rec_dtype(cfg) == jnp.int16:
        r = r & 0xFFFF  # undo the int16 sign extension
    is_final = (r & 1) != 0
    dist = r >> 8
    sdl = jnp.where((r != 0) & ~is_final, ((r >> 1) & 0x7F) - 64, 0)
    m = jnp.minimum(read_len.astype(jnp.int32), L)
    n = jnp.minimum(ref_len.astype(jnp.int32), L)
    dl_final = (n - m) - jnp.sum(sdl, axis=0)
    run_final = jnp.sum(jnp.where(is_final, dist, 0), axis=0)
    has_final = jnp.any(is_final, axis=0)
    # the in-loop steps fill rows [0, T); the final leap moves to the tail
    sdl_t = sdl[:T].T  # [B, T]
    sdist_t = jnp.where(is_final, 0, dist)[:T].T
    ops_even = jnp.where(sdl_t < 0, OP_I, OP_D).astype(jnp.int8)
    ops_odd = jnp.full((B, T), OP_M, jnp.int8)
    ops_steps = jnp.stack([ops_even, ops_odd], axis=2).reshape(B, 2 * T)
    runs_steps = jnp.stack([jnp.abs(sdl_t), sdist_t], axis=2).reshape(B, 2 * T)
    op_leap_f = jnp.where(dl_final < 0, OP_I, OP_D).astype(jnp.int8)
    ops_ = jnp.concatenate(
        [ops_steps, op_leap_f[:, None], jnp.full((B, 1), OP_M, jnp.int8)],
        axis=1)
    runs_ = jnp.concatenate(
        [runs_steps, jnp.where(has_final, jnp.abs(dl_final), 0)[:, None],
         run_final[:, None]], axis=1)
    return dict(
        cost=cost,
        cigar_ops=ops_,
        cigar_runs=runs_,
        cigar_count=jnp.sum(runs_ > 0, axis=1, dtype=jnp.int32),
        steps=steps,
    )
