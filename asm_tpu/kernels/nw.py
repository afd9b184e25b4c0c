"""Batched exact Needleman-Wunsch/Gotoh affine-gap global alignment.

The accuracy oracle of the framework — the batched replacement for the
reference's parasail dependency (GASMA/benchmark/benchmark_utils.h:104-150).
Penalty convention (pinned by tests against asm_tpu.reference_impl.nw_ref):
mismatch costs x, a gap of length L costs o + (L-1)*e, penalty = minimized
total (== -parasail score with matrix ("ACGT", 0, -x), benchmark_utils.h:288).

Design: instead of parasail's striped-SIMD single-pair DP, the batch of
pairs IS the parallel axis. The DP runs as an anti-diagonal wavefront
(jax.lax.scan over 2L diagonals): every cell of one diagonal depends only on
the two previous diagonals, so a whole diagonal is one fused elementwise
pass over [B, L]. Only cells i in [1, L] are stored: the i == 0 top-border
column has the closed form o + (d-1)*e and is folded in as the shift fill,
so every state array is exactly [B, L].

No data-dependent shapes: all pairs run the full 2L-step wavefront and each
pair's result is snapshotted at its own final diagonal d == m+n via a
one-hot masked reduce (gather-free).

Traceback (for CIGAR / the coverage metric) stores one packed pointer byte
per cell per diagonal during the forward scan, then replays the diagonals
in a reverse lax.scan: each pair advances exactly when the scan reaches its
cursor's diagonal, fetching its pointer byte with a one-hot reduce over
that [B, L] slice — no gathers anywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from asm_tpu.utils.profiling import scoped

# plain int (not jnp scalar): module import must not initialize the backend
INF = 1 << 29

# traceback op codes (host-side RLE turns these into CIGAR strings)
OP_NONE = 0
OP_EQ = 1  # '='
OP_X = 2  # 'X'
OP_I = 3  # 'I' consumes s1 (read)
OP_D = 4  # 'D' consumes s2 (ref)


def _wavefront(read_codes, ref_codes, read_len, ref_len, x, o, e, want_trace):
    """Shared forward pass. Returns (penalty[B], ptr_stack or None).

    Coordinates: cell (i, j) aligns read[:i] with ref[:j]; diagonal d = i+j.
    State arrays hold cells i in [1, L] at index q = i-1 (see module
    docstring for why i == 0 is virtual). H/E/F as in Gotoh: E = gap
    consuming the read ('I'), F = gap consuming the ref ('D').
    """
    B, L = read_codes.shape
    ii = 1 + jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)  # i = q+1

    # cell i uses read[i-1] = read_codes[:, q]
    aa = read_codes
    # cell i of diag d uses ref[d-i-1] = b_rev_pad[(2L+1-d) + q]
    b_rev = jnp.flip(ref_codes, axis=1)
    b_rev_pad = jnp.concatenate(
        [
            jnp.full((B, L), -2, dtype=jnp.int8),
            b_rev,
            jnp.full((B, L), -2, dtype=jnp.int8),
        ],
        axis=1,
    )

    m = read_len.astype(jnp.int32)
    mn = m + ref_len.astype(jnp.int32)  # final diagonal per pair

    h0 = jnp.full((B, L), INF, dtype=jnp.int32)  # diag 0 has no i >= 1 cells
    e0 = jnp.full((B, L), INF, dtype=jnp.int32)
    f0 = jnp.full((B, L), INF, dtype=jnp.int32)
    # pairs with an empty read end on the virtual top border: closed form
    pen0 = jnp.where(
        mn == 0, 0, jnp.where(m == 0, o + (mn - 1) * e, INF)
    )

    def shift_i(arr, fill):
        """value at cell i-1 (state index q-1); q=0 reads `fill` (= the
        virtual i == 0 border cell)."""
        return jnp.concatenate(
            [jnp.full((B, 1), fill, dtype=arr.dtype), arr[:, :-1]], axis=1
        )

    def h_top(dd):
        """closed-form H at the virtual top-border cell (0, dd)."""
        return jnp.where(dd <= 0, jnp.where(dd == 0, 0, INF), o + (dd - 1) * e)

    def step(carry, d):
        h1, h2, e1, f1, pen = carry
        # gap-state recurrences (open preferred on ties, matching nw_ref)
        e_open = shift_i(h1, h_top(d - 1)) + o
        e_ext = shift_i(e1, INF) + e
        e_new = jnp.minimum(e_open, e_ext)
        f_open = h1 + o
        f_ext = f1 + e
        f_new = jnp.minimum(f_open, f_ext)

        # substitution from diagonal d-2
        bb = jax.lax.dynamic_slice_in_dim(b_rev_pad, 2 * L + 1 - d, L, axis=1)
        mis = (aa != bb).astype(jnp.int32)
        sub = shift_i(h2, h_top(d - 2)) + x * mis

        h_new = jnp.minimum(sub, jnp.minimum(e_new, f_new))

        # left-border cell of this diagonal: i == d (j = 0)
        border_pen = o + (d - 1) * e
        at_left = ii == d
        h_new = jnp.where(at_left, border_pen, h_new)
        e_new = jnp.where(at_left, border_pen, e_new)
        f_new = jnp.where(at_left, INF, f_new)
        # cells beyond the valid triangle (i > d) are never read; leave as-is

        # snapshot the final cell for pairs whose alignment ends on diagonal
        # d (one-hot masked reduce; m == 0 pairs were closed-form in pen0)
        val = jnp.sum(jnp.where(ii == m[:, None], h_new, 0), axis=1)
        pen = jnp.where((d == mn) & (m > 0), val, pen)

        if want_trace:
            # packed pointer byte: bits0-1 H-source (0 diag, 1 E, 2 F),
            # bit2 E-open, bit3 F-open, bit4 mismatch
            ptr_h = jnp.where(
                h_new == sub,
                0,
                jnp.where(h_new == e_new, 1, 2),
            )
            ptr_h = jnp.where(at_left, 1, ptr_h)
            e_is_open = e_open <= e_ext
            e_is_open = jnp.where(at_left, d == 1, e_is_open)
            f_is_open = f_open <= f_ext
            ptr = (
                ptr_h.astype(jnp.uint8)
                | (e_is_open.astype(jnp.uint8) << 2)
                | (f_is_open.astype(jnp.uint8) << 3)
                | (mis.astype(jnp.uint8) << 4)
            )
        else:
            ptr = None

        return (h_new, h1, e_new, f_new, pen), ptr

    (h, _, _, _, penalty), ptrs = jax.lax.scan(
        step,
        (h0, h0, e0, f0, pen0),
        jnp.arange(1, 2 * L + 1, dtype=jnp.int32),
    )
    return penalty, ptrs  # ptrs: [2L, B, L] uint8 (diag d at index d-1)


@functools.partial(jax.jit, static_argnames=("x", "o", "e"))
@scoped("nw")
def nw_penalty(read_codes, read_len, ref_codes, ref_len, x=1, o=1, e=1):
    """Exact global alignment penalty, no traceback. int32[B]."""
    pen, _ = _wavefront(read_codes, ref_codes, read_len, ref_len, x, o, e, False)
    return pen


@functools.partial(
    jax.jit, static_argnames=("x", "o", "e", "match_mask_threshold")
)
@scoped("nw")
def nw_align(read_codes, read_len, ref_codes, ref_len, x=1, o=1, e=1,
             match_mask_threshold: int | None = None):
    """Exact global alignment with traceback.

    Returns (penalty int32[B], ops int8[B, 2L]) where ops lists OP_* codes in
    REVERSE alignment order (traceback order), OP_NONE-padded. Use
    asm_tpu.ops.cigar.ops_to_cigar to render CIGAR strings.

    match_mask_threshold: if set, additionally returns bool[B, L] marking
    READ positions inside '=' runs of length >= threshold — the positions
    whose characters the reference's LCM string collects
    (long_consecutive_matching_substring, benchmark_coverage.h:26-67, as
    called with the NW CIGAR and threshold 3 by benchmark_utils.h:256).
    Computed during the same traceback scan; enables full-corpus
    device-side coverage without materializing CIGAR strings.
    """
    B, L = read_codes.shape
    penalty, ptrs = _wavefront(
        read_codes, ref_codes, read_len, ref_len, x, o, e, True
    )
    # Traceback as a REVERSE scan over the stored pointer diagonals: the
    # scan visits d = 2L .. 1; a pair whose cursor sits on diagonal d takes
    # exactly one move (to d-1 on a gap, d-2 on a substitution) and idles
    # otherwise — the per-step byte fetch is a one-hot reduce over the
    # [B, L] diagonal slice, never a gather. Total moves per pair <= 2L and
    # d strictly decreases per move, so one sweep suffices. Cells at i == 0
    # are not stored (module docstring): their byte is the closed form
    # "F-gap, opened iff d == 1".
    ww = 1 + jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    ww0 = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)  # 0-based read pos
    want_mask = match_mask_threshold is not None

    def step(carry, xs):
        d, ptr_d = xs  # scalar diag index, [B, L] pointer bytes of diag d
        if want_mask:
            i, j, st, run, mask = carry
        else:
            i, j, st = carry
        active = (i + j == d) & ((i > 0) | (j > 0))
        fetched = jnp.sum(
            jnp.where(ww == i[:, None], ptr_d, jnp.uint8(0)).astype(jnp.int32),
            axis=1,
        )
        top_byte = 2 | jnp.where(d == 1, 8, 0)  # virtual i == 0 cell
        byte = jnp.where(i == 0, top_byte, fetched)
        ptr_h = byte & 3
        e_open = (byte >> 2) & 1
        f_open = (byte >> 3) & 1
        mis = (byte >> 4) & 1

        # state: 0 = H, 1 = E (in a read-gap run), 2 = F (ref-gap run)
        go_diag = (st == 0) & (ptr_h == 0)
        go_e = ((st == 0) & (ptr_h == 1)) | (st == 1)
        go_f = ((st == 0) & (ptr_h == 2)) | (st == 2)

        op = jnp.where(
            go_diag,
            jnp.where(mis == 1, OP_X, OP_EQ),
            jnp.where(go_e, OP_I, OP_D),
        ).astype(jnp.int8)
        op = jnp.where(active, op, OP_NONE).astype(jnp.int8)

        di = jnp.where(go_diag | go_e, 1, 0)
        dj = jnp.where(go_diag | go_f, 1, 0)
        new_st = jnp.where(
            go_diag,
            0,
            jnp.where(
                go_e,
                jnp.where(e_open == 1, 0, 1),
                jnp.where(f_open == 1, 0, 2),
            ),
        )
        if want_mask:
            # '='-run bookkeeping (alignment-order runs are contiguous in
            # traceback order too): when a run ends at read cursor i with
            # count `run`, the run covered read positions [i, i + run).
            # Only ACTIVE steps advance the walk — a pair idles on scan
            # steps between its diagonals, which must not touch the run.
            is_eq = active & go_diag & (mis == 0)
            ends = active & ~is_eq
            mark = (run > 0) & ends & (run >= match_mask_threshold)
            mask = mask | (
                mark[:, None] & (ww0 >= i[:, None])
                & (ww0 < (i + run)[:, None])
            )
            run = jnp.where(is_eq, run + 1, jnp.where(ends, 0, run))

        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        st = jnp.where(active, new_st, st).astype(jnp.int32)
        if want_mask:
            return (i, j, st, run, mask), op
        return (i, j, st), op

    ds = jnp.arange(2 * L, 0, -1, dtype=jnp.int32)
    init = (read_len.astype(jnp.int32), ref_len.astype(jnp.int32),
            jnp.zeros((B,), jnp.int32))
    if want_mask:
        init = init + (jnp.zeros((B,), jnp.int32), jnp.zeros((B, L), bool))
    carry, ops_rev = jax.lax.scan(step, init, (ds, jnp.flip(ptrs, axis=0)))
    # ops_rev: [2L, B] in traceback (reverse-alignment) order
    if want_mask:
        i, _, _, run, mask = carry
        # flush a run still open at the end of the scan (alignment starts
        # with '=' at read position 0)
        mask = mask | (
            ((run >= match_mask_threshold) & (run > 0))[:, None]
            & (ww0 >= i[:, None]) & (ww0 < (i + run)[:, None])
        )
        return penalty, ops_rev.T, mask
    return penalty, ops_rev.T
