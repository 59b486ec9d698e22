"""Pallas-Triton kernel for batched Myers bit-vector edit distance.

Drop-in replacement for ops/myers.myers_bottom_row (Hyyrö's blocked
formulation; reference counterpart: cudaaligner/src/myers_gpu.cu [U]).  The
XLA twin is a `lax.scan` over target columns, so every column costs at least
one kernel launch that does a few hundred bit-ops per problem.  Here one
launch walks all columns of a query strip in an in-kernel loop:

- one problem per thread: a program holds BLOCK_B problems (one warp), the
  grid covers the batch;
- a strip of up to STRIP_WORDS query words keeps its Pv/Mv state and its
  four Peq masks in registers for the whole column sweep;
- queries longer than one strip run one launch per strip: each launch hands
  the next the horizontal delta of its last word, one int8 per (column,
  problem), so the carry chain of Hyyrö's block step crosses strips exactly
  as it crosses words;
- the bottom-row score D[qlen, j] comes from bit (qlen-1) % 32 of word
  (qlen-1) // 32, so the strip holding that word writes the rows.

Outputs are integers and bit-identical to ops/myers.myers_bottom_row
(asserted by tests in interpret mode and by chip_smoke.py on the card).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils.mathutils import round_up
from .myers import WORD, build_peq, num_words

#: problems per program: one warp, one problem per thread
BLOCK_B = 32
#: query words whose state stays in registers during one column sweep
#: (Pv + Mv + 4 Peq = 6 registers per word and thread; 32 measured faster
#: than 8 and 16 at Lq = 2048 and 8192 on an H100, see PERF.md)
STRIP_WORDS = 32

_ONES = 0xFFFFFFFF


def _kernel(*refs, ws: int, Lt: int, bb: int, has_hin: bool,
            has_hout: bool):
    it = iter(refs)
    peq_ref, t_ref, qlen_ref, wl_ref = next(it), next(it), next(it), next(it)
    hin_ref = next(it) if has_hin else None
    rows_ref = next(it)
    hout_ref = next(it) if has_hout else None

    lanes = pl.ds(pl.program_id(0) * bb, bb)
    u32 = jnp.uint32
    peq = [[peq_ref[s, w, lanes] for w in range(ws)] for s in range(4)]
    qlen = qlen_ref[lanes]
    wl = wl_ref[lanes]                  # strip-local word of the bottom row
    bit = (jnp.maximum(qlen - 1, 0) % WORD).astype(u32)
    q0 = qlen == 0
    ones = jnp.full((bb,), 1, u32)
    zeros = jnp.zeros((bb,), u32)

    def column(j, carry):
        pv, mv, score = carry
        c = t_ref[j, lanes].astype(jnp.int32)
        c01, c0, c2 = c <= 1, c == 0, c == 2
        pos = jnp.where(c >= 0, u32(_ONES), u32(0))
        if has_hin:
            h = hin_ref[j, lanes].astype(jnp.int32)
            hin_pos = (h > 0).astype(u32)
            hin_neg = (h < 0).astype(u32)
        else:
            hin_pos, hin_neg = ones, zeros       # D[0,j]-D[0,j-1] = +1
        ph_sel, mh_sel = zeros, zeros
        pv2, mv2 = [], []
        for w in range(ws):
            Pv, Mv = pv[w], mv[w]
            Eq = jnp.where(c01, jnp.where(c0, peq[0][w], peq[1][w]),
                           jnp.where(c2, peq[2][w], peq[3][w])) & pos
            Eq2 = Eq | hin_neg
            Xv = Eq | Mv
            Xh = (((Eq2 & Pv) + Pv) ^ Pv) | Eq2
            Ph_pre = Mv | ~(Xh | Pv)
            Mh_pre = Pv & Xh
            mine = wl == w
            ph_sel = jnp.where(mine, Ph_pre, ph_sel)
            mh_sel = jnp.where(mine, Mh_pre, mh_sel)
            nxt_pos = Ph_pre >> (WORD - 1)
            nxt_neg = Mh_pre >> (WORD - 1)
            Ph = (Ph_pre << 1) | hin_pos
            Mh = (Mh_pre << 1) | hin_neg
            pv2.append(Mh | ~(Xv | Ph))
            mv2.append(Ph & Xv)
            hin_pos, hin_neg = nxt_pos, nxt_neg
        delta = (((ph_sel >> bit) & 1).astype(jnp.int32)
                 - ((mh_sel >> bit) & 1).astype(jnp.int32))
        score = jnp.where(q0, j + 1, score + delta)
        plgpu.store(rows_ref.at[j, lanes], score,
                    mask=(wl >= 0) & (wl < ws))
        if has_hout:
            hout = hin_pos.astype(jnp.int32) - hin_neg.astype(jnp.int32)
            hout_ref[j, lanes] = hout.astype(jnp.int8)
        return tuple(pv2), tuple(mv2), score

    init = (tuple(jnp.full((bb,), _ONES, u32) for _ in range(ws)),
            tuple(zeros for _ in range(ws)), qlen)
    jax.lax.fori_loop(0, Lt, column, init)


def _strip(peq, tT, qlen, wl, hin, *, Lt, Bp, has_hout, interpret):
    """One launch over a strip: peq holds the strip's words (4, ws, Bp) and
    wl each problem's bottom-row word relative to the strip, so every
    middle strip of a query reuses one compiled kernel."""
    bb = BLOCK_B
    ws = peq.shape[1]
    kernel = functools.partial(_kernel, ws=ws, Lt=Lt, bb=bb,
                               has_hin=hin is not None, has_hout=has_hout)
    out_shape = [jax.ShapeDtypeStruct((Lt, Bp), jnp.int32)]
    if has_hout:
        out_shape.append(jax.ShapeDtypeStruct((Lt, Bp), jnp.int8))
    args = (peq, tT, qlen, wl) + ((hin,) if hin is not None else ())
    outs = pl.pallas_call(
        kernel, grid=(Bp // bb,), out_shape=tuple(out_shape),
        compiler_params=plgpu.CompilerParams(num_warps=bb // 32,
                                             num_stages=1),
        interpret=interpret, name=f"myers_strip_w{ws}",
    )(*args)
    return outs if has_hout else (outs[0], None)


@functools.partial(jax.jit, static_argnames=("n_words", "interpret",
                                              "strip_words"))
def myers_bottom_row_pallas(q, qlen, t, tlen, n_words: int | None = None,
                            interpret: bool = False,
                            strip_words: int = STRIP_WORDS):
    """Drop-in replacement for ops.myers.myers_bottom_row: returns
    (rows (B, Lt+1) int32, scores (B,) int32).  strip_words only trades
    registers against launches; every value gives identical output."""
    B, Lq = q.shape
    Lt = t.shape[1]
    Wq = n_words or num_words(Lq)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    Bp = round_up(max(B, BLOCK_B), BLOCK_B)

    qp = jnp.pad(q.astype(jnp.int32), ((0, Bp - B), (0, 0)),
                 constant_values=-1)
    qlenp = jnp.pad(qlen, (0, Bp - B))
    tT = jnp.pad(t.astype(jnp.int8), ((0, Bp - B), (0, 0)),
                 constant_values=-1).T                       # (Lt, Bp)
    peq = build_peq(qp, Wq)                                  # (4, Wq, Bp)

    wlast = jnp.maximum(qlenp - 1, 0) // WORD
    strip_of = wlast // strip_words
    rows, hin = None, None
    starts = list(range(0, Wq, strip_words))
    for s, w0 in enumerate(starts):
        ws = min(strip_words, Wq - w0)
        r_s, hin = _strip(peq[:, w0:w0 + ws], tT, qlenp, wlast - w0, hin,
                          Lt=Lt, Bp=Bp, has_hout=s + 1 < len(starts),
                          interpret=interpret)
        # rows a strip does not own are left unwritten: keep the owner's
        rows = r_s if rows is None else jnp.where(strip_of == s, r_s, rows)

    rows = jnp.concatenate([qlen[:, None], rows.T[:B]], axis=1)  # (B, Lt+1)
    scores = jnp.take_along_axis(rows, tlen[:, None], axis=1)[:, 0]
    return rows, scores
