"""Batched banded Needleman–Wunsch (edit distance) — XLA scan formulation.

XLA twin of the reference's banded/"Ukkonen" GPU kernel (reference:
cudaaligner/src/ukkonen_gpu.cu [U]); ops/nw_diag_pallas.py is the Triton
kernel with identical scores and paths.  Instead of an anti-diagonal sweep
with one thread block per alignment, the whole batch is ONE XLA program:

- Lane layout: lane k of a width-W vector tracks the fixed diagonal offset
  delta = j - i = k - r (r = band radius, W = 2r+1 padded to the 128-lane
  boundary).  A `lax.scan` walks query rows i = 1..Lq; every step updates all
  band cells of all B problems at once — an (B, W) elementwise block.
- The within-row deletion chain D[i,j] = min(..., D[i,j-1]+1) — the part that
  breaks naive row vectorization — is solved in closed form:
      D[i,k] = k + cummin_{l<=k}(tmp[l] - l)
  a min-plus prefix scan over lanes (log depth).
- Traceback move codes (AlignmentState) are emitted per row into an
  (Lq, B, W) uint8 array using the package-canonical tie-break
  (diag, then deletion, then insertion — see cpu/nw_oracle.py).

Cells outside the band, past sequence ends, or in padding lanes hold INF.
Scores and codes are bit-identical to cpu/nw_oracle.nw_banded_matrix by
construction (tests assert it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.status import AlignmentState, StatusType
from ..utils.mathutils import round_up

INF = np.int32(2**30)


def band_width(band_radius: int) -> int:
    return round_up(2 * band_radius + 1, 128)


def _cummin_minplus(tmp: jnp.ndarray) -> jnp.ndarray:
    """D[.., k] = k + min_{l<=k}(tmp[.., l] - l) along the last axis."""
    W = tmp.shape[-1]
    lane = jax.lax.broadcasted_iota(jnp.int32, tmp.shape, tmp.ndim - 1)
    c = tmp - lane
    c = jax.lax.associative_scan(jnp.minimum, c, axis=tmp.ndim - 1)
    return c + lane


@functools.partial(jax.jit, static_argnames=("band_radius",))
def banded_nw(q: jnp.ndarray, qlen: jnp.ndarray, t: jnp.ndarray,
              tlen: jnp.ndarray, band_radius: int):
    """Batched banded NW.

    Args:
      q: (B, Lq) int8/int32 base codes, PAD (-1) beyond qlen.
      qlen, tlen: (B,) int32 true lengths.
      t: (B, Lt) codes.
      band_radius: static band radius r (|i - j| <= r).

    Returns:
      scores: (B,) int32 edit distance (INF where the band excludes a path —
        callers map that to EXCEEDED_MAX_ALIGNMENT_DIFFERENCE).
      tb: (Lq, B, W) uint8 traceback codes for rows i = 1..Lq.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    r = band_radius
    W = band_width(r)

    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)

    # t_pad[b, r + x] = t[b, x]; slicing at offset i-1 yields t[j-1] per lane.
    t_pad = jnp.full((B, r + Lt + W), -1, dtype=jnp.int32)
    t_pad = jax.lax.dynamic_update_slice(t_pad, t, (0, r))

    lane = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)       # (1, W)
    delta = lane - r                                            # j - i
    in_band_lane = lane <= 2 * r
    m = tlen[:, None]                                           # (B, 1)
    n = qlen[:, None]

    # Row 0: D[0, j] = j within band and j <= m.
    j0 = delta
    row0 = jnp.where((j0 >= 0) & (j0 <= m) & in_band_lane,
                     j0, INF).astype(jnp.int32)
    row0 = jnp.broadcast_to(row0, (B, W))
    final0 = jnp.where(qlen == 0, jnp.minimum(tlen, INF), INF)

    def step(carry, i):
        prev, final = carry                                     # (B, W), (B,)
        jv = i + delta                                          # j per lane
        valid = (jv >= 0) & (jv <= m) & (i <= n) & in_band_lane
        tvec = jax.lax.dynamic_slice_in_dim(t_pad, i - 1, W, axis=1)
        qch = jax.lax.dynamic_slice_in_dim(q, i - 1, 1, axis=1)  # (B, 1)
        sub = jnp.where((qch == tvec) & (qch >= 0), 0, 1).astype(jnp.int32)

        up = jnp.concatenate(
            [prev[:, 1:], jnp.full((B, 1), INF, jnp.int32)], axis=1)
        tmp = jnp.minimum(prev + sub, up + 1)
        tmp = jnp.where(jv == 0, i, tmp)          # first column D[i,0] = i
        tmp = jnp.where(valid, tmp, INF)
        cur = _cummin_minplus(tmp)
        cur = jnp.where(valid, jnp.minimum(cur, INF), INF).astype(jnp.int32)

        left = jnp.concatenate(
            [jnp.full((B, 1), INF, jnp.int32), cur[:, :-1]], axis=1)
        code = jnp.where(
            cur == prev + sub, sub,               # MATCH(0) / MISMATCH(1)
            jnp.where(cur == left + 1,
                      jnp.int32(AlignmentState.DELETION),
                      jnp.int32(AlignmentState.INSERTION)))
        code = code.astype(jnp.uint8)

        lane_final = r + tlen - qlen              # (B,)
        at_final = (i == qlen)
        score_i = jnp.take_along_axis(
            cur, jnp.clip(lane_final, 0, W - 1)[:, None], axis=1)[:, 0]
        final = jnp.where(at_final, score_i, final)
        return (cur, final), code

    (_, final), tb = jax.lax.scan(
        step, (row0, final0), jnp.arange(1, Lq + 1, dtype=jnp.int32))

    band_ok = jnp.abs(qlen - tlen) <= r
    scores = jnp.where(band_ok, final, INF)
    return scores, tb


def traceback_paths(tb: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
                    band_radius: int, use_native: str = "auto"
                    ) -> list[list[int]]:
    """Host-side decode of the banded traceback array (Lq, B, W), one code
    per byte, into edit paths.  Dispatches to the native C++ decoder
    (native/traceback.cpp) when built — a single linear scan per problem.
    The pure-Python fallback below walks all B problems in lockstep with
    vectorized NumPy (the per-problem walk is inherently serial — O(n+m)
    steps — but all problems advance together, mirroring the reference's
    dedicated backtrace kernel (reference: cudaaligner/src/ukkonen_gpu.cu
    backtrace phase [U])).  Returns AlignmentState code lists in forward
    (left-to-right) order; both decoders produce identical paths (asserted
    by tests).
    """
    if use_native in ("auto", "native"):
        try:
            from ..io import native_traceback
            paths, _ = native_traceback.decode(tb, qlen, tlen, band_radius)
            return paths
        except ImportError:
            if use_native == "native":
                raise
    tb = np.asarray(tb).view(np.uint8)
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B = tb.shape[1]
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
        del_row = active & (i == 0)            # row 0: pure deletion tail
        read = active & (i > 0)
        code = np.zeros(B, dtype=np.uint8)
        lanes = np.clip(r + j - i, 0, tb.shape[2] - 1)
        rows = np.clip(i - 1, 0, tb.shape[0] - 1)
        code[read] = tb[rows[read], np.nonzero(read)[0], lanes[read]]
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
