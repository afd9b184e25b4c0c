"""Batched profile-profile alignment (MSA step) — matrix product + wavefront DP.

Batched re-design of the ProfileProfileAlignment prototype
(pymatch/algorithms/MSA.py:19-103). The prototype computes one PSP profile
dot product `p1[i] @ S @ p2[j]` per DP cell in Python; here the profile
contraction is hoisted into one matrix product — `p2s = p2 @ S.T` once per batch, so
each wavefront step needs only an elementwise dot over the 5-channel axis
— and the maximizing DP runs as the same anti-diagonal [B, L] wavefront as
the NW kernel (scan over 2L diagonals, i in [1, L] stored, virtual top
border via running cumulative gap scores).

Score convention (MSA.py:30-38): match +1, mismatch -2, gap-vs-gap 0;
linear gap scores psp(column, '-'). Tie-break match > insert('|', consumes
profile 1) > delete('-') exactly as MSA.py:89-97.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from asm_tpu.reference_impl.msa_ref import GAP_VEC, create_pssm, score_matrix

NEG = -1e30

OP_M = 1
OP_I = 3  # consumes profile 1 (prototype '|')
OP_D = 4  # consumes profile 2 (prototype '-')


def profiles_from_alignments(alignments: list[list[str]], max_len: int):
    """Host-side: list of alignments (rows of equal length) -> batched
    PSSM arrays float32[B, max_len, 5] + lengths int32[B]."""
    B = len(alignments)
    out = np.zeros((B, max_len, 5), np.float32)
    lens = np.zeros(B, np.int32)
    for b, al in enumerate(alignments):
        p = create_pssm(al)
        n = min(p.shape[0], max_len)
        out[b, :n] = p[:n]
        lens[b] = n
    return out, lens


@functools.partial(jax.jit, static_argnames=("match", "mismatch"))
def profile_align(p1, len1, p2, len2, match: float = 1.0,
                  mismatch: float = -2.0):
    """Batched profile-profile alignment.

    Args: p1/p2 float32[B, L, 5] PSSMs (zero rows past len), len1/len2
    int32[B]. Returns dict(score float32[B], ops int8[B, 2L] traceback in
    reverse order — codes OP_M/OP_I/OP_D, 0-padded).
    """
    B, L, _ = p1.shape
    S = jnp.asarray(score_matrix(match, mismatch), jnp.float32)
    gap = jnp.asarray(GAP_VEC, jnp.float32)

    # contract profiles with the score matrix once. HIGHEST precision:
    # reduced-precision passes (bf16, TF32) cost ~1e-2 on 1/3-valued
    # profiles, and
    # these contractions are a negligible fraction of the DP work.
    hp = jax.lax.Precision.HIGHEST
    p2s = jnp.einsum("bjc,dc->bjd", p2, S, precision=hp)  # p2s[j] = S@p2[j]
    gap1 = jnp.einsum(
        "bic,c->bi", jnp.einsum("bic,cd->bid", p1, S, precision=hp), gap,
        precision=hp,
    )
    gap2 = jnp.einsum("bjd,d->bj", p2s, gap, precision=hp)  # psp(None, j)

    ii = 1 + jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    # cell i of diag d pairs p1[i-1] with p2s[d-i-1]: reverse + pad p2s
    p2s_rev = jnp.flip(p2s, axis=1)
    p2s_pad = jnp.concatenate(
        [jnp.zeros((B, L, 5)), p2s_rev, jnp.zeros((B, L, 5))], axis=1
    )
    # border scores: D[i, 0] = cumsum(gap1), D[0, j] = cumsum(gap2)
    cum1 = jnp.concatenate(
        [jnp.zeros((B, 1)), jnp.cumsum(gap1, axis=1)], axis=1
    )  # [B, L+1]
    cum2 = jnp.concatenate(
        [jnp.zeros((B, 1)), jnp.cumsum(gap2, axis=1)], axis=1
    )

    mn = len1 + len2
    valid1 = ii <= len1[:, None]  # rows beyond the profile are invalid

    def top_border(dd):
        """D[0, dd] via one-hot reduce over cum2 (gather-free); dd may be
        a scalar diagonal or a per-pair [B] vector."""
        dd = jnp.asarray(dd)
        if dd.ndim == 1:
            dd = dd[:, None]
        jidx = jax.lax.broadcasted_iota(jnp.int32, (B, L + 1), 1)
        return jnp.sum(jnp.where(jidx == dd, cum2, 0.0), axis=1)

    def shift_i(arr, fill):
        return jnp.concatenate([fill[:, None], arr[:, :-1]], axis=1)

    h0 = jnp.full((B, L), NEG, jnp.float32)
    score0 = jnp.where(mn == 0, 0.0,
                       jnp.where(len1 == 0, top_border(mn), NEG))

    def step(carry, d):
        h1, h2, score = carry
        top1 = top_border(d - 1)  # D[0, d-1]
        top2 = top_border(d - 2)
        psp_d = jnp.sum(
            p1 * jax.lax.dynamic_slice(
                p2s_pad, (0, 2 * L + 1 - d, 0), (B, L, 5)
            ),
            axis=-1,
        )  # [B, L]
        m = shift_i(h2, top2) + psp_d
        ins = shift_i(h1, top1) + gap1  # consumes p1 row i
        # delete: same i, previous diagonal; gap2 cost of column j-1 = d-i-1
        g2_d = jnp.sum(
            gap * jax.lax.dynamic_slice(
                p2s_pad, (0, 2 * L + 1 - d, 0), (B, L, 5)
            ),
            axis=-1,
        )
        dele = h1 + g2_d
        h_new = jnp.maximum(m, jnp.maximum(ins, dele))
        # left border cell i == d: only insert chain (D[i, 0])
        at_left = ii == d
        left_val = jnp.sum(
            jnp.where(
                jax.lax.broadcasted_iota(jnp.int32, (B, L + 1), 1) == d,
                cum1, 0.0,
            ),
            axis=1,
        )
        h_new = jnp.where(at_left, left_val[:, None], h_new)
        h_new = jnp.where(valid1, h_new, NEG)

        ptr = jnp.where(
            h_new == m, OP_M, jnp.where(h_new == ins, OP_I, OP_D)
        ).astype(jnp.int8)
        ptr = jnp.where(at_left, OP_I, ptr)

        val = jnp.sum(jnp.where(ii == len1[:, None], h_new, 0.0), axis=1)
        score = jnp.where((d == mn) & (len1 > 0), val, score)
        return (h_new, h1, score), ptr

    (h, _, score), ptrs = jax.lax.scan(
        step, (h0, h0, score0), jnp.arange(1, 2 * L + 1, dtype=jnp.int32)
    )

    # traceback: reverse scan over pointer diagonals (same pattern as nw)
    ww = 1 + jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)

    def tb_step(carry, xs):
        d, ptr_d = xs
        i, j = carry
        active = (i + j == d) & ((i > 0) | (j > 0))
        fetched = jnp.sum(
            jnp.where(ww == i[:, None], ptr_d, jnp.int8(0)).astype(jnp.int32),
            axis=1,
        )
        op = jnp.where(i == 0, OP_D, fetched)
        di = jnp.where((op == OP_M) | (op == OP_I), 1, 0)
        dj = jnp.where((op == OP_M) | (op == OP_D), 1, 0)
        out = jnp.where(active, op, 0).astype(jnp.int8)
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        return (i, j), out

    ds = jnp.arange(2 * L, 0, -1, dtype=jnp.int32)
    _, ops_rev = jax.lax.scan(
        tb_step, (len1.astype(jnp.int32), len2.astype(jnp.int32)),
        (ds, jnp.flip(ptrs, axis=0)),
    )
    return dict(score=score, ops=ops_rev.T)
