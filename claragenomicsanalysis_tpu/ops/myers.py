"""Batched Myers bit-vector edit distance (Hyyrö's blocked formulation).

XLA twin of the reference's Myers GPU kernel
(reference: cudaaligner/src/myers_gpu.cu [U]); ops/myers_pallas.py is the
Triton kernel with bit-identical output.  Differences by design:

- 32-bit uint32 words (the reference uses warp-cooperative u32/u64 words);
  batch B vectorised, words Wq statically unrolled.
- The kernel tracks the BOTTOM-ROW score D[qlen, j] for every column j
  (reference tracks the same running score).  That row is exactly what
  Hirschberg's divide step needs, so this one op powers both the `myers`
  score path and the `hirschberg-myers` long-read path.
- Traceback is NOT done from stored PV/MV columns (the reference's approach):
  instead, the measured edit distance s bounds an optimal path to the band
  |i-j| <= s, so the canonical banded-NW kernel re-derives the exact
  canonical path (see align/myers_aligner.py for the argument).

Semantics identical to cpu/nw_oracle: unit-cost global edit distance,
negative codes never match.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

WORD = 32
_MSB = np.uint32(1) << (WORD - 1)
_ONES = np.uint32(0xFFFFFFFF)


def num_words(max_query_length: int) -> int:
    return max(1, -(-max_query_length // WORD))


def build_peq(q: jnp.ndarray, Wq: int) -> jnp.ndarray:
    """Peq[sigma, w, b]: bit p set iff q[b, 32w+p] == sigma.  (4, Wq, B)."""
    B, Lq = q.shape
    pad = Wq * WORD - Lq
    qp = jnp.pad(q.astype(jnp.int32), ((0, 0), (0, pad)), constant_values=-1)
    qw = qp.reshape(B, Wq, WORD)                      # (B, Wq, 32)
    bits = (jnp.uint32(1) << jnp.arange(WORD, dtype=jnp.uint32))
    out = []
    for sigma in range(4):
        m = (qw == sigma).astype(jnp.uint32) * bits   # (B, Wq, 32)
        out.append(jnp.sum(m, axis=2).T)              # (Wq, B)
    return jnp.stack(out)                             # (4, Wq, B)


def _advance_block(Pv, Mv, Eq, hin):
    """Hyyrö 2003 block advance; all args (B,) uint32 except hin (B,) int32.
    Returns (Pv', Mv', hout)."""
    hin_neg = (hin < 0).astype(jnp.uint32)
    hin_pos = (hin > 0).astype(jnp.uint32)
    Eq2 = Eq | hin_neg
    Xv = Eq | Mv
    Xh = (((Eq2 & Pv) + Pv) ^ Pv) | Eq2
    Ph_pre = Mv | ~(Xh | Pv)
    Mh_pre = Pv & Xh
    hout = ((Ph_pre >> (WORD - 1)) & 1).astype(jnp.int32) - \
           ((Mh_pre >> (WORD - 1)) & 1).astype(jnp.int32)
    Ph = (Ph_pre << 1) | hin_pos
    Mh = (Mh_pre << 1) | hin_neg
    Pv2 = Mh | ~(Xv | Ph)
    Mv2 = Ph & Xv
    return Pv2, Mv2, Ph_pre, Mh_pre, hout


@functools.partial(jax.jit, static_argnames=("n_words",))
def myers_bottom_row(q, qlen, t, tlen, n_words: int | None = None):
    """Returns (rows, scores): rows (B, Lt+1) int32 with rows[b, j] =
    D[qlen_b, j] (the bottom DP row), scores (B,) = D[qlen_b, tlen_b].

    Columns j > tlen_b continue past the target end (harmless; callers mask).
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    Wq = n_words or num_words(Lq)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)

    peq = build_peq(q, Wq)                            # (4, Wq, B)
    t32 = t.astype(jnp.int32)

    wlast = jnp.maximum(qlen - 1, 0) // WORD          # (B,)
    bit_last = (jnp.maximum(qlen - 1, 0) % WORD).astype(jnp.uint32)
    widx = jnp.arange(Wq, dtype=jnp.int32)[:, None]   # (Wq, 1)

    Pv0 = jnp.full((Wq, B), _ONES, dtype=jnp.uint32)
    Mv0 = jnp.zeros((Wq, B), dtype=jnp.uint32)
    score0 = qlen

    def step(carry, j):
        Pv, Mv, score = carry
        c = jax.lax.dynamic_slice_in_dim(t32, j, 1, axis=1)[:, 0]   # (B,)
        Eq_full = jnp.zeros((Wq, B), jnp.uint32)
        for sigma in range(4):
            Eq_full = jnp.where(c[None, :] == sigma, peq[sigma], Eq_full)

        hin = jnp.ones((B,), jnp.int32)               # D[0,j]-D[0,j-1] = +1
        Pv_n, Mv_n = [], []
        delta = jnp.zeros((B,), jnp.int32)
        for w in range(Wq):
            Pv2, Mv2, Ph, Mh, hout = _advance_block(Pv[w], Mv[w],
                                                    Eq_full[w], hin)
            # bottom-row delta: pre-shift Ph/Mh bit (qlen-1) % 32 of wlast
            d_w = ((Ph >> bit_last) & 1).astype(jnp.int32) - \
                  ((Mh >> bit_last) & 1).astype(jnp.int32)
            Pv_n.append(Pv2)
            Mv_n.append(Mv2)
            delta = jnp.where(wlast == w, d_w, delta)
            hin = hout
        Pv = jnp.stack(Pv_n)
        Mv = jnp.stack(Mv_n)
        score = jnp.where(qlen == 0, j + 1, score + delta)
        return (Pv, Mv, score), score

    (_, _, _), rows = jax.lax.scan(step, (Pv0, Mv0, score0),
                                   jnp.arange(Lt, dtype=jnp.int32))
    rows = jnp.concatenate([score0[None, :], rows], axis=0).T  # (B, Lt+1)
    scores = jnp.take_along_axis(rows, tlen[:, None], axis=1)[:, 0]
    return rows, scores

