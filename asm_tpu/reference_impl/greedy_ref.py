"""Scalar emulator of the GASMA greedy hurdle-matrix kernel.

Mirrors GASMA/hurdle_matrix.h step by step, including its quirks:

  * `num_switches` is only refreshed when a lane's cached highway is
    recomputed (hurdle_matrix.h:293-294), so a cache hit scores the
    significance heuristic with a stale switch count;
  * the best-highway scan is sequential over lanes with a `>` /
    `(==, leap >)` tie-break (hurdle_matrix.h:345-351), so the LOWEST lane
    wins ties of (heuristic, leap_heuristic);
  * `_choose_best_highway`'s running minima update only when BOTH
    total_cost and intermediate_cost do not increase (hurdle_matrix.h:391-397)
    — an order-dependent sequential scan;
  * `reaching_destination` is re-derived on every `_update_highway_list`
    call and only set by lanes recomputed in THAT call (hurdle_matrix.h:290,309);
  * significance weights are C doubles log(p/0.25) (hurdle_matrix.h:536-538);
  * the final leap emits an 'M' run equal to the HURDLE COUNT, not the
    column distance (hurdle_matrix.h:581-589);
  * when the destination lane lies outside the band [-k, k], the reference
    reads a stale destination column (highways::reset only touches in-band
    lanes, hurdle_matrix.h:106-119) and a default-constructed lane row; in
    the benchmark flow this degenerates to "pay the switch penalty, zero
    hurdles" — reproduced here explicitly.

Deviation (documented): positions past a string's end are deterministic
mismatches (sentinel padding) instead of stale buffer bytes
(hurdle_matrix.h:497). The band is always [-k, k] because the benchmark
binary does not define CORRECTION (CMakeLists.txt has no such flag;
hurdle_matrix.h:509-512 #else branch).

Float-tie sensitivity (documented; affects kernel-vs-emulator diffs):
with the benchmark probabilities, mismatch_sig and indel_sig are
MATHEMATICALLY EQUAL (both log((0.2/3)/0.25) — indel_prob/2 == 0.4/3/2 ==
0.2/3 exactly in IEEE doubles), so any two lanes with equal length and
equal nhur+nsw have heuristics that are exact mathematical ties, ordered
only by last-ulp rounding of the two-sum. That ordering depends on
precision and FMA contraction: this emulator (Python doubles, no FMA)
matches the reference compiled as shipped; the float32 batched kernels —
and even float64 XLA, which contracts mul+add into FMA — can break such
ties the other way, changing the chosen highway and hence the COST by a
few units on rare pairs. Measured kernel-vs-emulator cost diffs: 0/512
at err<=0.10 (the validated rates), 1/512 at err=0.20, 18/512 on the
pathological err=0.4 indel-heavy corpus (deltas skew NEGATIVE — the
flipped ties usually find cheaper walks). The reference's own output is
compiler-flag-dependent at exactly these ties.
"""

from __future__ import annotations

import math

import numpy as np

from asm_tpu.config import AlignmentType

NEG_INF = -math.inf


def _calculate_destination(m: int, n: int, lane: int) -> int:
    """cf. GASMA/hurdle_matrix.h:58-68."""
    if m >= n:
        if lane > 0:
            return n - lane
        elif lane >= n - m:
            return n
        else:
            return m + lane
    else:
        if lane < 0:
            return m + lane
        elif lane <= n - m:
            return m
        else:
            return n - lane


def _switch_lane_penalty(l1: int, l2: int, o: int, e: int) -> int:
    if l1 == l2:
        return 0
    return o + e * (abs(l1 - l2) - 1)


def _switch_forward_column(l1: int, l2: int) -> int:
    if l1 * l2 >= 0:
        return abs(l1) - abs(l2) if abs(l1) > abs(l2) else 0
    return abs(l1)


class _Row:
    """An L-bit row with the reference's register semantics
    (bit p == column p; shifts saturate to zero past the register width)."""

    __slots__ = ("bits", "L")

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.L = len(bits)

    def shift_from(self, s: int) -> "_Row":
        """reference shift_left(s): out[p] = bits[p+s], zero fill; all-zero
        for s >= L (utils.h:143-153 with slli/srli saturation)."""
        out = np.zeros(self.L, dtype=np.int8)
        if 0 <= s < self.L:
            out[: self.L - s] = self.bits[s:]
        return _Row(out)

    def first_one(self) -> int:
        nz = np.flatnonzero(self.bits)
        return int(nz[0]) if nz.size else self.L

    def first_zero(self) -> int:
        nz = np.flatnonzero(self.bits == 0)
        return int(nz[0]) if nz.size else self.L

    def pop_count_between(self, lo: int, hi: int) -> int:
        """cf. utils.h:263-270; inverted/out-of-range windows count 0."""
        lo_c = max(min(lo, self.L), 0)
        hi_c = max(min(hi, self.L), 0)
        if hi_c <= lo_c:
            return 0
        return int(self.bits[lo_c:hi_c].sum())

    def flip_short_hurdles(self, threshold: int = 1) -> "_Row":
        h = self.bits
        near = np.zeros_like(h)
        near[:-1] |= h[1:]
        near[1:] |= h[:-1]
        if threshold > 1:
            near[:-2] |= h[2:]
            near[2:] |= h[:-2]
        return _Row(h & near)


def _build_lanes(a_codes, b_codes, lb, ub, L, flip_threshold):
    """cf. _construct_hurdles, hurdle_matrix.h:441-455."""
    lanes = {}
    lanes_orig = {}
    for lane in range(lb, ub + 1):
        row = np.zeros(L, dtype=np.int8)
        for p in range(L):
            ai = p + (-lane if lane < 0 else 0)
            bi = p + (lane if lane > 0 else 0)
            av = a_codes[ai] if ai < L else 6
            bv = b_codes[bi] if bi < L else 6
            row[p] = 1 if av != bv else 0
        r = _Row(row)
        lanes_orig[lane] = r
        lanes[lane] = r.flip_short_hurdles(flip_threshold)
    return lanes, lanes_orig


def greedy_ref(
    s1: str,
    s2: str,
    k: int = 3,
    x: int = 1,
    o: int = 1,
    e: int = 1,
    alignment_type: AlignmentType = AlignmentType.GLOBAL,
    match_prob: float = 0.80,
    mismatch_prob: float = 0.20 / 3,
    indel_prob: float = 0.40 / 3,
    max_len: int = 128,
    flip_threshold: int = 1,
    return_trace: bool = False,
    max_steps: int | None = None,
):
    """Run the greedy hurdle-matrix alignment; returns (cost, cigar).

    With return_trace=True also returns a list of per-step
    (chosen_lane, new_column) for kernel debugging. max_steps bounds the
    highway steps like the kernel's AlignConfig.max_steps (the walk then
    ends with the final leap from wherever it stopped); the reference
    itself has no bound (None).
    """
    L = max_len
    m = min(len(s1), L)
    n = min(len(s2), L)
    a_codes = np.full(L, 4, dtype=np.int16)
    b_codes = np.full(L, 5, dtype=np.int16)
    lut = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i in range(m):
        a_codes[i] = lut.get(s1[i], 0)
    for i in range(n):
        b_codes[i] = lut.get(s2[i], 0)

    lb, ub = -k, k
    lanes, lanes_orig = _build_lanes(a_codes, b_codes, lb, ub, L, flip_threshold)
    dest = {lane: _calculate_destination(m, n, lane) for lane in range(lb, ub + 1)}
    destination_lane = n - m

    match_sig = math.log(match_prob / 0.25)
    mismatch_sig = math.log(mismatch_prob / 0.25)
    indel_sig = math.log(indel_prob / 2 / 0.25)

    # highway cache (cf. highways::reset, hurdle_matrix.h:106-119)
    sp = {lane: -1 for lane in range(lb, ub + 1)}
    length = {lane: 0 for lane in range(lb, ub + 1)}
    swc = {lane: L for lane in range(lb, ub + 1)}
    hc = {lane: L for lane in range(lb, ub + 1)}
    nsw = {lane: L for lane in range(lb, ub + 1)}
    nhur = {lane: L for lane in range(lb, ub + 1)}

    cur_lane = 0
    cur_col = 0
    cost = 0
    is_first_step = True
    cigar: list[str] = []
    trace = []

    def update_cigar(best_lane, curr_lane, mismatches, matches):
        # cf. _update_CIGAR, hurdle_matrix.h:238-251
        if best_lane < curr_lane:
            cigar.append(f"{curr_lane - best_lane}I")
        elif best_lane > curr_lane:
            cigar.append(f"{best_lane - curr_lane}D")
        if mismatches + matches > 0:
            cigar.append(f"{mismatches + matches}M")

    def update_highway_list():
        # cf. _update_highway_list, hurdle_matrix.h:285-362
        nonlocal best_sel
        reaching = False
        for lane in range(lb, ub + 1):
            start_col = cur_col + _switch_forward_column(cur_lane, lane)
            if sp[lane] < start_col:
                nsw[lane] = abs(lane - cur_lane)
                row = lanes[lane].shift_from(start_col)
                fz = row.first_zero()
                nh = row.shift_from(fz).first_one()
                sp[lane] = start_col + fz
                length[lane] = nh
                if start_col + fz + nh > dest[lane]:
                    length[lane] = max(0, dest[lane] - (start_col + fz))
                    reaching = True
            sc = 0
            if alignment_type == AlignmentType.GLOBAL or not is_first_step:
                sc = _switch_lane_penalty(cur_lane, lane, o, e)
            nhur[lane] = lanes_orig[lane].pop_count_between(
                start_col, sp[lane] + length[lane]
            )
            swc[lane] = sc
            hc[lane] = x * nhur[lane]

        largest_h = NEG_INF
        largest_lh = -(2**31)
        best = 0
        for lane in range(lb, ub + 1):
            current_cost = -swc[lane] - hc[lane]
            h = (
                match_sig * length[lane]
                + mismatch_sig * nhur[lane]
                + indel_sig * nsw[lane]
            )
            lh = -swc[lane]
            if reaching:
                fsc = 0
                if alignment_type == AlignmentType.GLOBAL:
                    fsc = _switch_lane_penalty(lane, destination_lane, o, e)
                h = float(
                    current_cost
                    - fsc
                    - x * (dest[lane] - sp[lane] - length[lane])
                )
                lh -= fsc
            if h > largest_h or (h == largest_h and lh > largest_lh):
                largest_h = h
                largest_lh = lh
                best = lane
        best_sel = best
        return length[best] > 0

    def choose_best_highway():
        # cf. _choose_best_highway, hurdle_matrix.h:368-401
        best = best_sel
        starting_point = sp[best]
        best_cost = hc[best] + swc[best]
        sic = best_cost
        stc = best_cost
        bil = best
        for lane in range(lb, ub + 1):
            if lane == best:
                continue
            if sp[lane] + _switch_forward_column(lane, best) > starting_point:
                continue
            ep = sp[lane] + length[lane]
            ic = swc[lane] + lanes_orig[lane].pop_count_between(
                cur_col + _switch_forward_column(cur_lane, lane), ep
            )
            tc = (
                ic
                + _switch_lane_penalty(lane, best, o, e)
                + max(
                    0,
                    x
                    * lanes_orig[best].pop_count_between(
                        _switch_forward_column(lane, best) + ep, starting_point
                    ),
                )
            )
            if tc <= stc and ic <= sic:
                stc = tc
                sic = ic
                bil = lane
        return bil

    best_sel = 0
    # cf. run(), hurdle_matrix.h:568-597
    while max_steps is None or len(trace) < max_steps:
        if not update_highway_list():
            is_first_step = False
            break
        bl = choose_best_highway()
        cost += swc[bl] + hc[bl]
        distance = sp[bl] + length[bl] - (
            cur_col + _switch_forward_column(cur_lane, bl)
        )
        update_cigar(bl, cur_lane, distance - length[bl], length[bl])
        cur_lane = bl
        cur_col = sp[bl] + length[bl]
        trace.append((cur_lane, cur_col))
        is_first_step = False
        if cur_col >= dest[cur_lane]:
            break

    if lb <= destination_lane <= ub:
        destination_column = dest[destination_lane]
        if cur_lane != destination_lane or cur_col < destination_column:
            sc = 0
            if alignment_type == AlignmentType.GLOBAL:
                sc = _switch_lane_penalty(cur_lane, destination_lane, o, e)
            distance = lanes_orig[destination_lane].pop_count_between(
                cur_col + _switch_forward_column(cur_lane, destination_lane),
                destination_column,
            )
            hcost = max(0, x * distance)
            cost += sc + hcost
            update_cigar(destination_lane, cur_lane, distance, 0)
    else:
        # out-of-band destination lane: stale destination (<= 0) and a
        # default lane row -> switch penalty only (see module docstring)
        if cur_lane != destination_lane:
            sc = 0
            if alignment_type == AlignmentType.GLOBAL:
                sc = _switch_lane_penalty(cur_lane, destination_lane, o, e)
            cost += sc
            update_cigar(destination_lane, cur_lane, 0, 0)

    result = (cost, "".join(cigar))
    if return_trace:
        return result + (trace,)
    return result
