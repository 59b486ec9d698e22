"""Anti-diagonal banded NW as a Pallas-Triton kernel.

The XLA twin (ops/nw_band.banded_nw) walks query rows and pays a log-depth
min-plus prefix scan per row for the in-row deletion chain, one scan step
(and at least one launch) per row.  Along an ANTI-DIAGONAL d = i + j the DP
cells are independent — every dependency points at d-1 or d-2 — so one
kernel launch sweeps all diagonals in an in-kernel loop with a 3-way min per
cell (reference counterpart: cudaaligner/src/ukkonen_gpu.cu [U], which also
sweeps anti-diagonals with one block per alignment).

Layout: a program holds a (BB problems, W half-band cells) tile.  With
u = j - i + r, cells on diagonal d satisfy u ≡ d + r (mod 2), so
consecutive diagonals use interleaved half-bands: par = (d + r) & 1,
u = 2k + par, k in [0, r - par].  Dependencies at (d, k):

    diag  D[i-1, j-1] -> (d-2, k)
    up    D[i-1, j  ] -> (d-1, k + par)
    left  D[i,   j-1] -> (d-1, k + par - 1)

The ±1 neighbour on the previous half-band belongs to another thread, so
each diagonal is written to a small per-program buffer (double-buffered,
INF-padded on both ends) and read back at an offset after a block barrier;
the buffer stays in L1.  Query characters come from a reversed copy of the
query (i decreases as k grows), target characters from a padded copy, both
as contiguous dynamic-offset loads.

Outputs match ops/nw_band.banded_nw: scores are the same banded edit
distances, and the 2-bit move codes use the identical tie-break (diag,
then DELETION via left+1, else INSERTION), packed four DIAGONALS per byte
in a (B, Dpad/4, r+1) array — decode with traceback_paths_diag or the
native decoder (native/traceback.cpp).  The boundary needs no special code
beyond i == 0 -> j: INF propagation from out-of-band dependencies gives the
correct values and codes on every reachable in-band cell.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.status import AlignmentState
from ..utils.mathutils import round_up
from .nw_band import INF

#: widest half-band tile (cells) the kernel holds: r + 1 <= MAX_BAND_CELLS.
#: At 8 warps that is 16 cells per thread for each of the ~8 live tiles,
#: inside the 255-register budget of a thread.
MAX_BAND_CELLS = 4096
MAX_RADIUS = MAX_BAND_CELLS - 1
#: cells per thread a program aims for (tile = BB x W = 128 x this)
_CELLS_PER_WARP = 128


def _pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def tile_shape(band_radius: int) -> tuple[int, int, int]:
    """(BB problems, W half-band cells, num_warps) of one program."""
    W = _pow2(band_radius + 1)
    bb = max(1, 512 // W)
    num_warps = min(8, max(1, bb * W // _CELLS_PER_WARP))
    return bb, W, num_warps


def n_diag_bytes(Lq: int, Lt: int) -> int:
    """Packed rows per problem: four anti-diagonals per byte."""
    return round_up(Lq + Lt + 1, 4) // 4


def _kernel(qbuf_ref, tbuf_ref, qlen_ref, tlen_ref, score_ref, tb_ref,
            scr_ref, *, r: int, W: int, bb: int, n_chunks: int, qoff: int,
            toff: int, interpret: bool):
    rows = pl.ds(pl.program_id(0) * bb, bb)
    k = jax.lax.broadcasted_iota(jnp.int32, (bb, W), 1)
    qlen = qlen_ref[rows][:, None]
    tlen = tlen_ref[rows][:, None]
    qlen_u = qlen.astype(jnp.uint32)
    tlen_u = tlen.astype(jnp.uint32)
    inf = jnp.full((bb, W), int(INF), jnp.int32)
    band = (k <= r, k <= r - 1)             # in-band half-band cells per par
    n_del = jnp.int32(int(AlignmentState.DELETION))
    n_ins = jnp.int32(int(AlignmentState.INSERTION))

    def barrier():
        if not interpret:                   # interpret mode runs in order
            plgpu.debug_barrier()

    # both buffer slots INF, including the pad cell at each end
    for slot in range(2):
        scr_ref[rows, slot, pl.ds(0, W)] = inf
        scr_ref[rows, slot, pl.ds(2, W)] = inf
    barrier()

    def chunk(ci, carry):
        prev1, prev2, sacc = carry
        acc = jnp.zeros((bb, W), jnp.int32)
        for rr in range(4):                 # chunk base is even: par static
            d = ci * 4 + rr
            par = (rr + r) % 2
            i_top = (d + r) >> 1            # i at k = 0
            i_vec = i_top - k
            j_vec = d - i_vec
            qch = qbuf_ref[rows, pl.ds(qoff - i_top, W)]
            tch = tbuf_ref[rows, pl.ds(toff + d - i_top, W)]
            sub = jnp.where((qch == tch) & (qch >= 0), 0, 1)
            # one unsigned compare covers 0 <= x <= len per side
            valid = ((i_vec.astype(jnp.uint32) <= qlen_u)
                     & (j_vec.astype(jnp.uint32) <= tlen_u) & band[par])
            if par == 0:
                up = prev1
                left = scr_ref[rows, (rr + 1) % 2, pl.ds(0, W)]
            else:
                up = scr_ref[rows, (rr + 1) % 2, pl.ds(2, W)]
                left = prev1
            diag = prev2 + sub
            cur = jnp.minimum(diag, jnp.minimum(up, left) + 1)
            cur = jnp.where(i_vec == 0, j_vec, cur)   # top row (and (0,0))
            cur = jnp.where(valid, cur, inf)
            code = jnp.where(cur == diag, sub,
                             jnp.where(cur == left + 1, n_del, n_ins))
            acc = acc | (code << (2 * rr))
            hit = (i_vec == qlen) & (j_vec == tlen) & valid
            sacc = sacc + jnp.where(hit, cur, 0)
            scr_ref[rows, rr % 2, pl.ds(1, W)] = cur
            barrier()
            prev2, prev1 = prev1, cur
        plgpu.store(tb_ref.at[rows, ci, pl.ds(0, W)], acc.astype(jnp.int8),
                    mask=k <= r)
        return prev1, prev2, sacc

    _, _, sacc = jax.lax.fori_loop(
        0, n_chunks, chunk, (inf, inf, jnp.zeros((bb, W), jnp.int32)))
    score_ref[rows] = jnp.sum(sacc, axis=1)


@functools.partial(jax.jit, static_argnames=("band_radius", "interpret"))
def banded_nw_diag_pallas(q, qlen, t, tlen, band_radius: int,
                          interpret: bool = False):
    """Banded NW, anti-diagonal sweep.  Same score semantics as
    ops.nw_band.banded_nw; returns (scores (B,) int32, tb (B, Dpad/4, r+1)
    int8 with four DIAGONALS' 2-bit codes per byte)."""
    B, Lq = q.shape
    Lt = t.shape[1]
    r = band_radius
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"band radius {r} outside [0, {MAX_RADIUS}]")
    bb, W, num_warps = tile_shape(r)
    Bp = round_up(max(B, bb), bb)
    n_chunks = n_diag_bytes(Lq, Lt)
    Dpad = 4 * n_chunks
    i_top_max = (Dpad - 1 + r) // 2

    # reversed query: qbuf[padq + p] = q[Lq - 1 - p]; cell k of diagonal d
    # reads q[i-1] = qbuf[padq + Lq - i_top + k]
    padq = max(0, i_top_max - Lq)
    qbuf = jnp.full((Bp, padq + Lq + W), -1, jnp.int8)
    qbuf = jax.lax.dynamic_update_slice(
        qbuf, jnp.pad(q.astype(jnp.int8)[:, ::-1], ((0, Bp - B), (0, 0)),
                      constant_values=-1), (0, padq))
    # target: tbuf[padt + p] = t[p]; cell k reads t[j-1] =
    # tbuf[padt - 1 + d - i_top + k], and d - i_top >= -(r+1)//2
    padt = r // 2 + 2
    tbuf = jnp.full((Bp, padt + Dpad + W), -1, jnp.int8)
    tbuf = jax.lax.dynamic_update_slice(
        tbuf, jnp.pad(t.astype(jnp.int8), ((0, Bp - B), (0, 0)),
                      constant_values=-1), (0, padt))
    qlenp = jnp.pad(qlen.astype(jnp.int32), (0, Bp - B))
    tlenp = jnp.pad(tlen.astype(jnp.int32), (0, Bp - B))

    kernel = functools.partial(
        _kernel, r=r, W=W, bb=bb, n_chunks=n_chunks, qoff=padq + Lq,
        toff=padt - 1, interpret=interpret)
    scores, tb, _ = pl.pallas_call(
        kernel, grid=(Bp // bb,),
        out_shape=(jax.ShapeDtypeStruct((Bp,), jnp.int32),
                   jax.ShapeDtypeStruct((Bp, n_chunks, r + 1), jnp.int8),
                   jax.ShapeDtypeStruct((Bp, 2, W + 2), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret, name=f"nw_diag_w{W}",
    )(qbuf, tbuf, qlenp, tlenp)

    band_ok = jnp.abs(qlenp[:B] - tlenp[:B]) <= r
    return jnp.where(band_ok, scores[:B], INF), tb[:B]


def traceback_paths_diag(tb: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
                         band_radius: int) -> list:
    """Host decode of the anti-diagonal 2-bit traceback into edit paths —
    same output convention as ops/nw_band.traceback_paths (forward-order
    AlignmentState code lists; row 0 is a pure deletion tail).  Cell (i, j)
    lives at diagonal d = i + j, half-band cell k = (j - i + r - par) / 2
    with par = (d + r) & 1; four diagonals pack per byte.  The reference
    for native/traceback.cpp's diagonal layout."""
    tb = np.asarray(tb).view(np.uint8)
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B = tb.shape[0]
    r = band_radius
    i = qlen.copy()
    j = tlen.copy()
    max_steps = int((qlen + tlen).max()) if B else 0
    code_mat = np.zeros((max_steps, B), dtype=np.uint8)
    act_mat = np.zeros((max_steps, B), dtype=bool)
    active = (i > 0) | (j > 0)
    for s in range(max_steps):
        if not active.any():
            break
        del_row = active & (i == 0)
        read = active & (i > 0)
        code = np.zeros(B, dtype=np.uint8)
        d = i + j
        par = (d + r) & 1
        cells = np.clip((j - i + r - par) >> 1, 0, tb.shape[2] - 1)
        rows = np.clip(d >> 2, 0, tb.shape[1] - 1)
        byte = tb[np.nonzero(read)[0], rows[read], cells[read]]
        code[read] = (byte >> (2 * (d[read] & 3)).astype(np.uint8)) & 3
        code[del_row] = AlignmentState.DELETION
        code_mat[s] = code
        act_mat[s] = active
        di = np.isin(code, (AlignmentState.MATCH, AlignmentState.MISMATCH,
                            AlignmentState.INSERTION)) & active
        dj = np.isin(code, (AlignmentState.MATCH, AlignmentState.MISMATCH,
                            AlignmentState.DELETION)) & active
        i -= di.astype(np.int64)
        j -= dj.astype(np.int64)
        active = (i > 0) | (j > 0)
    return [code_mat[act_mat[:, b], b][::-1].tolist() for b in range(B)]
