"""Stateful scalar emulator of the reference's SIMD_ED kernel.

Mirrors GASMA/benchmark/LEAP_SIMD/SIMD_ED.cpp — the AVX2 banded
edit-distance kernel behind the LEAP_SIMD batch filter
(LEAP_SIMD/main.cpp:188-196) — including its CROSS-PAIR STATE LEAKS,
which LV_BAG shares structurally but which manifest in SIMD_ED's outputs:

  * the object's start/end/I_pos/D_pos tables are allocated in init_*
    (SIMD_ED.cpp:235-253, 462-479) and NEVER cleared between pairs
    (reset() only clears ED_pass / cur_ED / converge_ED,
    SIMD_ED.cpp:256-267, 483-486) — cells not overwritten for the
    current pair carry the previous pair's values;
  * run_levenshtein's ED_GLOBAL/SEMI_FREE_BEGIN correction
    (SIMD_ED.cpp:349-352) runs even when NO lane converged, recomputing
    ED_pass from the STALE final_ED/final_lane_idx of an earlier pair —
    a failing pair can report pass=true;
  * an e=0 convergence returns early (SIMD_ED.cpp:287-291), skipping
    that correction, so get_ED (which returns converge_ED in
    GLOBAL/SEMI_FREE_BEGIN, SIMD_ED.cpp:748-753) reports a stale value
    for identical strings in levenshtein mode, and the reset value
    1000000 in affine mode (reset_affine, SIMD_ED.cpp:485);
  * backtrack_affine stores the terminal match run at
    ED_info[ED_probe] (== ED_info[0]) instead of ED_info[ED_count]
    (SIMD_ED.cpp:719-720), so get_CIGAR's leading number
    (ED_info[ED_count].id_length, SIMD_ED.cpp:758) is stale and the
    last emitted edit's run is overwritten by the terminal run.

Because of these leaks the emulator is a CLASS processing pairs in
sequence, exactly like the C++ object in the reference driver loop.
`run_pair` also reports whether any leak influenced this pair's output
(computed by replaying the pair on a fresh emulator), so batched-kernel
tests can restrict bit-exact assertions to leak-free pairs — the batched
The batched kernels use fresh per-pair state by design (see kernels/leap.py).

Input conventions mirror LEAP_SIMD/main.cpp:137-196: per pair,
length = len(read) (truncated at 256); the ref is strncpy'd to that
length — zero-padded when shorter ('\\0' converts to code A=0,
bit_convert.cpp:60-79) and truncated when longer.

Masks come from asm_tpu.reference_impl.shd_ref.calculate_masks_ref,
already validated mask-for-mask against the compiled
SIMD_ED::calculate_masks (tools/validate_vs_reference.py).
"""

from __future__ import annotations

import copy

from asm_tpu.config import LeapMode
from asm_tpu.reference_impl import shd_ref

MAX_LENGTH = 256
UNREACHED = -2
MISMATCH, A_INS, B_INS = 0, 1, 2
_OPCHAR = {MISMATCH: "M", A_INS: "I", B_INS: "D"}

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _codes(s: str) -> list[int]:
    # any byte that is not C/G/T converts to 00 == A (bit_convert.cpp:60-79)
    return [_CODE.get(ch, 0) for ch in s]


class SimdEdRef:
    """One emulated SIMD_ED object; call init_levenshtein/init_affine,
    then run_pair(read, ref) per pair IN ORDER."""

    def __init__(self):
        self.total_lanes = 0

    # ---- init (SIMD_ED.cpp:214-254, 435-481) ----------------------------
    def init_levenshtein(self, ed_threshold: int,
                         mode: LeapMode = LeapMode.LOCAL,
                         shd_enable: bool = True):
        self.affine_mode = False
        self.shd_enable = shd_enable
        self.ed_t = ed_threshold
        self.mode = mode
        self.total_lanes = TL = 2 * ed_threshold + 3
        self.mid = ed_threshold + 1
        E = ed_threshold
        # new int[ED_t+1]() value-initializes to 0; the -2 fill loop stops
        # at j < ED_t, leaving column ED_t zero (SIMD_ED.cpp:235-245)
        self.start = [[0] * (E + 1) for _ in range(TL)]
        self.end = [[0] * (E + 1) for _ in range(TL)]
        for i in range(TL):
            for j in range(E):
                self.start[i][j] = UNREACHED
                self.end[i][j] = UNREACHED
        for i in range(1, TL - 1):
            ed = abs(i - self.mid)
            if mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_END):
                self.start[i][ed] = ed
            else:
                self.start[i][0] = ed
        self.cur_ed = [0] * TL
        # scalars below deliberately persist across pairs; a fresh object's
        # members are indeterminate in C++ — zero is the value a static /
        # global object (and calloc'd heap in practice) starts with
        self.ed_pass = False
        self.final_lane_idx = 0
        self.final_ed = 0
        self.converge_ed = 0
        # driver zeroes ED_info after init for determinism (heap garbage
        # in the reference); entries [type, id_length]
        self.ed_info = [[0, 0] for _ in range(E + 1)]
        self.ed_count = 0

    def init_affine(self, gap_threshold: int, af_threshold: int,
                    mode: LeapMode, ms_penalty: int, gap_open_penalty: int,
                    gap_ext_penalty: int, shd_enable: bool = False,
                    shd_threshold: int = 10):
        self.affine_mode = True
        self.ms = ms_penalty
        self.go = gap_open_penalty
        self.ge = gap_ext_penalty
        self.ed_t = gap_threshold
        self.af = af_threshold
        self.shd_enable = shd_enable
        self.shd_threshold = shd_threshold
        self.mode = mode
        self.total_lanes = TL = 2 * gap_threshold + 3
        self.mid = gap_threshold + 1
        E = af_threshold
        self.start = [[UNREACHED] * (E + 1) for _ in range(TL)]
        self.end = [[UNREACHED] * (E + 1) for _ in range(TL)]
        self.i_pos = [[UNREACHED] * (E + 1) for _ in range(TL)]
        self.d_pos = [[UNREACHED] * (E + 1) for _ in range(TL)]
        for i in range(TL):
            distance = abs(i - self.mid)
            if distance == 0 or mode in (LeapMode.LOCAL,
                                         LeapMode.SEMI_FREE_BEGIN):
                self.start[i][0] = distance
        self.ed_pass = False
        self.final_lane_idx = 0
        self.final_ed = 0
        self.converge_ed = 0
        self.ed_info = [[0, 0] for _ in range(E + 1)]
        self.ed_count = 0

    # ---- per-pair load (main.cpp:137,188-191) ----------------------------
    def load_pair(self, read: str, ref: str):
        length = min(len(read), MAX_LENGTH)
        a = _codes(read[:length])
        b = _codes(ref[:length]) + [0] * max(0, length - len(ref))
        self.buffer_length = length
        self.masks = shd_ref.calculate_masks_ref(a, b, self.ed_t,
                                                 width=MAX_LENGTH)

    def _count_id(self, lane_idx: int, start_pos: int) -> int:
        """count_ID_length_avx (SIMD_ED.cpp:10-61): distance from start_pos
        to the first set mask bit, clamped to buffer_length - start_pos
        (which the caller may have made negative — mirrored as-is)."""
        mask = self.masks[lane_idx - 1] >> max(start_pos, 0)
        first = (mask & -mask).bit_length() - 1 if mask else MAX_LENGTH
        return min(first, self.buffer_length - start_pos)

    # ---- reset + run (SIMD_ED.cpp:256-353, 483-616) ----------------------
    def _shd_gate(self) -> bool:
        # Affine mode passes SHD_threshold as bit_vec_filter_avx's
        # max_error (SIMD_ED.cpp:489), which is both the popcount
        # threshold AND the lane count — with the default SHD_threshold=10
        # the gate reads 2*10+1 masks from a 2*gap_threshold+3 array:
        # out-of-bounds heap reads (undefined behavior). main.cpp's affine
        # default keeps SHD off (main.cpp:97); so does this emulator.
        assert not self.affine_mode, (
            "affine SHD gate is UB in the reference (OOB mask reads); "
            "not emulated"
        )
        return shd_ref.bit_vec_filter_masks(
            self.masks, self.buffer_length, self.ed_t
        )

    def reset(self):
        self.ed_pass = False
        if self.affine_mode:
            self.converge_ed = 1000000
        else:
            for i in range(1, self.total_lanes - 1):
                if self.mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_END):
                    self.cur_ed[i] = abs(i - self.mid)
                else:
                    self.cur_ed[i] = 0

    def run(self):
        if self.affine_mode:
            self._run_affine()
        else:
            self._run_levenshtein()

    def _run_levenshtein(self):
        TL, mid, E = self.total_lanes, self.mid, self.ed_t
        start, end, cur = self.start, self.end, self.cur_ed
        if self.shd_enable and not self._shd_gate():
            self.ed_pass = False
            return
        for l in range(1, TL - 1):
            if cur[l] == 0:
                end[l][0] = self._count_id(l, start[l][0]) + start[l][0]
                if end[l][0] == self.buffer_length:
                    self.final_lane_idx = l
                    self.final_ed = 0
                    self.ed_pass = True
                    return  # skips the GLOBAL correction (SIMD_ED.cpp:291)
                cur[l] += 1
        for e in range(1, E + 1):
            for l in range(1, TL - 1):
                if cur[l] != e:
                    continue
                top = 1 if l >= mid else 0
                bot = 1 if l <= mid else 0
                max_start = end[l][e - 1] + 1
                if end[l - 1][e - 1] + top > max_start:
                    max_start = end[l - 1][e - 1] + top
                if end[l + 1][e - 1] + bot > max_start:
                    max_start = end[l + 1][e - 1] + bot
                start[l][e] = max_start
                end[l][e] = max_start + self._count_id(l, max_start)
                if end[l][e] == self.buffer_length:
                    self.final_lane_idx = l
                    self.final_ed = e
                    self.ed_pass = True
                    break
                cur[l] += 1
            if self.ed_pass:
                break
        if self.mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN):
            # runs on STALE final_* when nothing converged (SIMD_ED.cpp:349)
            self.converge_ed = self.final_ed + abs(self.final_lane_idx - mid)
            self.ed_pass = self.converge_ed <= E

    def _run_affine(self):
        TL, mid = self.total_lanes, self.mid
        start, end = self.start, self.end
        i_pos, d_pos = self.i_pos, self.d_pos
        ms, go, ge = self.ms, self.go, self.ge
        if self.shd_enable and not self._shd_gate():
            self.ed_pass = False
            return
        for l in range(1, TL - 1):
            if start[l][0] >= 0:
                lane_diff = abs(l - mid)
                # NOTE counts from lane_diff, not start[l][0] (they are
                # equal whenever start[l][0] >= 0) — SIMD_ED.cpp:501
                end[l][0] = self._count_id(l, lane_diff) + start[l][0]
                if end[l][0] == self.buffer_length:
                    self.final_lane_idx = l
                    self.final_ed = 0
                    self.ed_pass = True
                    return  # converge_ED stays 1000000 (SIMD_ED.cpp:513)
        for e in range(1, self.af + 1):
            for l in range(1, TL - 1):
                top = 1 if l >= mid else 0
                bot = 1 if l <= mid else 0
                # I_pos/D_pos keep their previous-pair value when neither
                # branch fires (no else clause — SIMD_ED.cpp:535-551)
                if (e >= go and end[l - 1][e - go] >= 0
                        and end[l - 1][e - go] > i_pos[l - 1][e - ge]):
                    i_pos[l][e] = end[l - 1][e - go] + top
                elif e >= ge and i_pos[l - 1][e - ge] >= 0:
                    i_pos[l][e] = i_pos[l - 1][e - ge] + top
                if (e >= go and end[l + 1][e - go] >= 0
                        and end[l + 1][e - go] > d_pos[l + 1][e - ge]):
                    d_pos[l][e] = end[l + 1][e - go] + bot
                elif e >= ge and d_pos[l + 1][e - ge] >= 0:
                    d_pos[l][e] = d_pos[l + 1][e - ge] + bot
                s = UNREACHED
                if e >= ms and end[l][e - ms] >= 0:
                    s = end[l][e - ms] + 1
                if i_pos[l][e] > s:
                    s = i_pos[l][e]
                if d_pos[l][e] > s:
                    s = d_pos[l][e]
                start[l][e] = s
                if s >= 0:
                    end[l][e] = s + self._count_id(l, s)
                    if end[l][e] == self.buffer_length:
                        if self.mode in (LeapMode.GLOBAL,
                                         LeapMode.SEMI_FREE_BEGIN):
                            lane_diff = abs(mid - l)
                            t = e
                            if lane_diff:
                                t += go + (lane_diff - 1) * ge
                            if t <= self.af and t < self.converge_ed:
                                self.final_lane_idx = l
                                self.final_ed = e
                                self.ed_pass = True
                                self.converge_ed = t
                        else:
                            self.final_lane_idx = l
                            self.final_ed = e
                            self.ed_pass = True
            if self.ed_pass:
                break

    def check_pass(self) -> bool:
        return self.ed_pass

    def get_ed(self) -> int:
        if self.mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN):
            return self.converge_ed
        return self.final_ed

    # ---- backtrack + CIGAR (SIMD_ED.cpp:355-433, 618-721, 755-780) -------
    def backtrack(self):
        if self.affine_mode:
            self._backtrack_affine()
        else:
            self._backtrack_levenshtein()

    def _backtrack_levenshtein(self):
        mid = self.mid
        info, n = self.ed_info, 0
        if self.mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN):
            for _ in range(self.converge_ed, self.final_ed, -1):
                info[n][1] = 0
                info[n][0] = B_INS if self.final_lane_idx > mid else A_INS
                n += 1
        lane, e = self.final_lane_idx, self.final_ed
        start, end = self.start, self.end
        while e != 0:
            info[n][1] = end[lane][e] - start[lane][e]
            top = 1 if lane >= mid else 0
            bot = 1 if lane <= mid else 0
            if start[lane][e] == end[lane][e - 1] + 1:
                info[n][0] = MISMATCH
            elif start[lane][e] == end[lane - 1][e - 1] + top:
                lane -= 1
                info[n][0] = A_INS
            elif start[lane][e] == end[lane + 1][e - 1] + bot:
                lane += 1
                info[n][0] = B_INS
            e -= 1
            n += 1
        info[n][1] = end[lane][0] - start[lane][0]
        self.ed_count = n

    def _backtrack_affine(self):
        mid, go, ge, ms = self.mid, self.go, self.ge, self.ms
        info, n = self.ed_info, 0
        if self.mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN):
            for _ in range(abs(mid - self.final_lane_idx)):
                info[n][1] = 0
                info[n][0] = B_INS if self.final_lane_idx > mid else A_INS
                n += 1
        lane, e = self.final_lane_idx, self.final_ed
        start, end = self.start, self.end
        i_pos, d_pos = self.i_pos, self.d_pos
        while e != 0:
            info[n][1] = end[lane][e] - start[lane][e]
            if start[lane][e] == i_pos[lane][e]:
                top = 1 if lane >= mid else 0
                while (e - ge >= 0
                       and i_pos[lane - 1][e - ge] + top == i_pos[lane][e]):
                    info[n][0] = A_INS
                    n += 1
                    info[n][1] = 0
                    lane -= 1
                    e -= ge
                    top = 1 if lane >= mid else 0
                info[n][0] = A_INS
                n += 1
                lane -= 1
                e -= go
            elif start[lane][e] == d_pos[lane][e]:
                bot = 1 if lane <= mid else 0
                while (e - ge >= 0
                       and d_pos[lane + 1][e - ge] + bot == d_pos[lane][e]):
                    info[n][0] = B_INS
                    n += 1
                    info[n][1] = 0
                    lane += 1
                    e -= ge
                    bot = 1 if lane <= mid else 0
                info[n][0] = B_INS
                n += 1
                lane += 1
                e -= go
            else:
                info[n][0] = MISMATCH
                n += 1
                e -= ms
        # THE BUG: terminal run stored at ED_info[ED_probe] == ED_info[0],
        # not ED_info[ED_count] (SIMD_ED.cpp:719-720)
        info[e][1] = end[lane][e] - start[lane][e]
        self.ed_count = n

    def get_cigar(self) -> str:
        out = [str(self.ed_info[self.ed_count][1])]
        for i in range(self.ed_count - 1, -1, -1):
            out.append(_OPCHAR[self.ed_info[i][0]])
            out.append(str(self.ed_info[i][1]))
        return "".join(out)

    # ---- convenience driver-loop step ------------------------------------
    def run_pair(self, read: str, ref: str, want_cigar: bool = True):
        """load + reset + run (+ backtrack when passed), mirroring
        LEAP_SIMD/main.cpp:188-196. Returns dict(passed, ed, cigar,
        leaked) where `leaked` marks outputs influenced by cross-pair
        state (detected by replaying the pair on a fresh clone)."""
        fresh = copy.deepcopy(self)
        if fresh.total_lanes:
            if fresh.affine_mode:
                fresh.init_affine(fresh.ed_t, fresh.af, fresh.mode,
                                  fresh.ms, fresh.go, fresh.ge,
                                  fresh.shd_enable, fresh.shd_threshold)
            else:
                fresh.init_levenshtein(fresh.ed_t, fresh.mode,
                                       fresh.shd_enable)
        outs = []
        for obj in (self, fresh):
            obj.load_pair(read, ref)
            obj.reset()
            obj.run()
            passed = obj.check_pass()
            cigar = None
            if passed and want_cigar:
                obj.backtrack()
                cigar = obj.get_cigar()
            outs.append((passed, obj.get_ed(), cigar))
        return dict(
            passed=outs[0][0], ed=outs[0][1], cigar=outs[0][2],
            leaked=outs[0] != outs[1],
        )
