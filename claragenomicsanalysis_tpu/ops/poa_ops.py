"""Batched partial-order-alignment device ops.

XLA redesign of the reference's generatePOAKernel pipeline
(reference: cudapoa/src/cudapoa_kernels.cu, cudapoa_topsort.cuh,
cudapoa_nw.cuh, cudapoa_add_alignment.cuh, cudapoa_generate_consensus.cuh,
cudapoa_generate_msa.cuh [U]).  Where the reference mutates a pointer-rich DAG
with one CUDA block per window, here each window is a fixed-shape SoA pytree
(padded node arrays) and every mutation is a masked scatter, so thousands of
windows run as ONE vmapped XLA program.

Semantics are defined by cpu/poa_oracle.py (canonical tie-breaks, level-Kahn
topological order) and asserted bit-identical by tests.

Per-window state (PoaState):
  base (N,) i32      node bases (-1 = unused slot)
  cov (N,) i32       per-node read coverage (weight-accumulated)
  npred (N,) i32     in-degree;  pred/predw (N, P) i32 sorted by pred index
  nsucc (N,) i32     out-degree (count only — no successor lists needed)
  nalig (N,) i32     aligned-clique links; alig (N, A) i32 sorted ascending
  node_count () i32, status () i32
  paths (S, L) i32   node visited by sequence s at its position j (-1 none)

Design notes:
- topological order = stable sort by (level, node index) where level(u) is
  the longest-path depth; levels are recomputed by fixpoint relaxation with
  WARM START from the previous levels (edges are only ever added, so levels
  only grow — convergence is a few sweeps for read-like data).
- graph-NW rows are computed in rank order under a lax.scan; the in-row
  horizontal gap chain is the closed form  row[j] = j*g + cummax(vals - j*g)
  (same min-plus trick as the pairwise banded NW kernel).
- all indices are clipped before scatter/gather so an overflowed window can
  never fault; its sticky status marks the outputs invalid instead.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import BatchSize, PoaScores
from ..core.status import StatusType

NEG = jnp.int32(-(2**30))


class PoaState(NamedTuple):
    base: jnp.ndarray
    cov: jnp.ndarray
    npred: jnp.ndarray
    pred: jnp.ndarray
    predw: jnp.ndarray
    nsucc: jnp.ndarray
    nalig: jnp.ndarray
    alig: jnp.ndarray
    node_count: jnp.ndarray
    status: jnp.ndarray
    paths: jnp.ndarray


def _sizes(bs: BatchSize):
    return (bs.padded_nodes, bs.max_pred_per_node, bs.max_aligned_per_node,
            bs.max_sequences_per_poa, bs.padded_seq)


def init_state(bs: BatchSize, seq0, w0, len0) -> PoaState:
    """Graph = simple chain for the first sequence
    (reference: cudapoa_kernels.cu window init [U])."""
    N, P, A, S, L = _sizes(bs)
    idx = jnp.arange(N, dtype=jnp.int32)
    active = idx < len0
    base = jnp.where(active, _padget(seq0, idx, -1), -1).astype(jnp.int32)
    cov = jnp.where(active, _padget(w0, idx, 0), 0).astype(jnp.int32)
    npred = jnp.where(active & (idx > 0), 1, 0).astype(jnp.int32)
    pred = jnp.full((N, P), -1, jnp.int32)
    pred = pred.at[:, 0].set(jnp.where(npred > 0, idx - 1, -1))
    ew = jnp.minimum(_padget(w0, jnp.maximum(idx - 1, 0), 0), _padget(w0, idx, 0))
    predw = jnp.zeros((N, P), jnp.int32)
    predw = predw.at[:, 0].set(jnp.where(npred > 0, ew, 0).astype(jnp.int32))
    nsucc = jnp.where(active & (idx < len0 - 1), 1, 0).astype(jnp.int32)
    nalig = jnp.zeros(N, jnp.int32)
    alig = jnp.full((N, A), -1, jnp.int32)
    paths = jnp.full((S, L), -1, jnp.int32)
    paths = paths.at[0].set(jnp.where(jnp.arange(L) < len0,
                                      jnp.arange(L, dtype=jnp.int32), -1))
    status = jnp.where(len0 > bs.max_nodes_per_window,
                       jnp.int32(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE),
                       jnp.int32(StatusType.SUCCESS))
    return PoaState(base, cov, npred, pred, predw, nsucc, nalig, alig,
                    jnp.int32(len0), status, paths)


def _padget(arr, idx, fill):
    """arr[idx] with out-of-range -> fill (idx may exceed len(arr))."""
    idx = jnp.asarray(idx)
    idx_c = jnp.clip(idx, 0, arr.shape[0] - 1)
    v = jnp.take(arr, idx_c, axis=0)
    ok = (idx >= 0) & (idx < arr.shape[0])
    if v.ndim > ok.ndim:                      # row gathers: broadcast mask
        ok = ok.reshape(ok.shape + (1,) * (v.ndim - ok.ndim))
    return jnp.where(ok, v, fill)


# ---------------------------------------------------------------- topsort

def topsort(state: PoaState, prev_level, max_iters: int):
    """Longest-path levels by warm-started fixpoint relaxation.
    Returns (level, order, rank, ok)."""
    N, P = state.pred.shape
    idx = jnp.arange(N, dtype=jnp.int32)
    active = idx < state.node_count
    slot_ok = jnp.arange(P)[None, :] < state.npred[:, None]

    def cond(c):
        _, changed, it = c
        return changed & (it < max_iters)

    def body(c):
        level, _, it = c
        pl = _padget(level, state.pred.reshape(-1), -1).reshape(N, P)
        pl = jnp.where(slot_ok, pl, -1)
        new = jnp.maximum(jnp.max(pl, axis=1) + 1, 0)
        new = jnp.where(active, new, level)
        return new, jnp.any(new != level), it + 1

    level0 = jnp.where(active, jnp.maximum(prev_level, 0), 0)
    level, changed, iters = jax.lax.while_loop(
        cond, body, (level0, jnp.bool_(True), jnp.int32(0)))
    ok = ~changed                       # converged (no cycle)
    key = jnp.where(active, level * N + idx, jnp.int32(2**30) + idx)
    order = jnp.argsort(key).astype(jnp.int32)
    rank = jnp.zeros(N, jnp.int32).at[order].set(idx)
    return level, order, rank, ok


# ---------------------------------------------------------------- graph NW

def graph_nw(state: PoaState, order, rank, seq, slen, scores: PoaScores,
             band_width: int = 0):
    """Sequence-vs-graph NW.  Returns the scores matrix S ((N+1, L+1), row
    r+1 = node order[r], row 0 = virtual source) for the traceback.

    band_width > 0 enables the static band of cpu/poa_oracle.py rule 8
    (reference: cudapoa/src/cudapoa_nw_banded.cuh [U]): row of rank r only
    keeps columns |j - ((r+1)*slen)//(node_count+1)| <= band_width//2."""
    N, P = state.pred.shape
    L = seq.shape[0]
    g = jnp.int32(scores.gap_score)
    jj = jnp.arange(L + 1, dtype=jnp.int32)
    row_virtual = jj * g
    Smat0 = jnp.full((N + 1, L + 1), NEG, jnp.int32).at[0].set(row_virtual)
    seq_valid = jnp.arange(L) < slen

    def step(Smat, r):
        u = order[r]
        act = r < state.node_count
        preds = state.pred[u]                       # (P,)
        slot_ok = jnp.arange(P) < state.npred[u]
        prow_idx = jnp.where(slot_ok, _padget(rank, preds, -1) + 1, 0)
        prows = jnp.take(Smat, jnp.clip(prow_idx, 0, N), axis=0)  # (P, L+1)
        prows = jnp.where(slot_ok[:, None], prows, NEG)
        pmax = jnp.max(prows, axis=0)
        pmax = jnp.where(state.npred[u] == 0, Smat[0], pmax)

        sub = jnp.where((seq == state.base[u]) & (seq >= 0),
                        scores.match_score, scores.mismatch_score)
        sub = jnp.where(seq_valid, sub, scores.mismatch_score)
        diag = pmax[:-1] + sub
        vert = pmax[1:] + g
        tmp = jnp.maximum(diag, vert)               # (L,)
        vals = jnp.concatenate([(pmax[:1] + g), tmp])  # (L+1,) j=0 col first
        if band_width > 0:
            c = ((r + 1) * slen) // (state.node_count + 1)
            in_band = jnp.abs(jj - c) <= band_width // 2
            vals = jnp.where(in_band, vals, NEG)
        # row[j] = j*g + cummax(vals[l] - l*g)
        cm = jax.lax.cummax(vals - jj * g)
        row = cm + jj * g
        if band_width > 0:
            row = jnp.where(in_band, row, NEG)
        row = jnp.where(act, row, NEG).astype(jnp.int32)
        Smat = jax.lax.dynamic_update_slice(Smat, row[None], (r + 1, 0))
        return Smat, ()

    Smat, _ = jax.lax.scan(step, Smat0, jnp.arange(N, dtype=jnp.int32))
    return Smat


def nw_traceback(state: PoaState, order, rank, Smat, seq, slen,
                 scores: PoaScores, path_len: int):
    """Canonical traceback (diag -> vertical -> horizontal; preds in
    ascending index order).  Returns (path_node, path_pos, start, band_ok)
    where entries [start:] of the fixed-length buffers are the forward-order
    path; inert slots hold -2.  band_ok is False when no global path exists
    inside the band (banded graph_nw left the best sink cell at ~NEG)."""
    N, P = state.pred.shape
    g = jnp.int32(scores.gap_score)
    TL = path_len

    # end cell: best sink at column slen; tie -> smallest rank (two-stage
    # max + first-argmax, so NEG cells never enter a key multiplication)
    idx = jnp.arange(N, dtype=jnp.int32)
    act_r = idx < state.node_count
    u_of_r = order
    sink = (_padget(state.nsucc, u_of_r, 1) == 0) & act_r
    val = jnp.take(Smat[1:, :], jnp.clip(slen, 0, Smat.shape[1] - 1), axis=1)
    vmax = jnp.max(jnp.where(sink, val, NEG))
    r_end = jnp.argmax(sink & (val == vmax)).astype(jnp.int32)
    band_ok = vmax > NEG // 2

    pn0 = jnp.full(TL, -2, jnp.int32)
    pp0 = jnp.full(TL, -2, jnp.int32)

    def cond(c):
        r, j, k, _, _ = c
        return ((r >= 0) | (j > 0)) & (k > 0)

    def body(c):
        r, j, k, pn, pp = c
        u = _padget(order, r, -1)
        here = Smat[jnp.clip(r + 1, 0, N), j]

        sc = _padget(seq, j - 1, -1)
        sub = jnp.where((sc == _padget(state.base, u, -2)) & (sc >= 0),
                        scores.match_score, scores.mismatch_score)

        preds = _padget(state.pred, u, -1)           # (P,) row gather
        nslots = _padget(state.npred, u, 0)
        slot_ok = jnp.arange(P) < nslots
        prow = jnp.where(slot_ok, _padget(rank, preds, -1) + 1, -1)
        # virtual-source handling: if no preds, single "slot" = row 0
        prow = jnp.where((jnp.arange(P) == 0) & (nslots == 0), 0, prow)
        slot_ok = slot_ok | ((jnp.arange(P) == 0) & (nslots == 0))
        pvals_d = jnp.take(Smat[:, :], jnp.clip(prow, 0, N), axis=0)
        pv_jm1 = jnp.take(pvals_d, jnp.clip(j - 1, 0, Smat.shape[1] - 1), axis=1)
        pv_j = jnp.take(pvals_d, j, axis=1)

        diag_ok = slot_ok & (j > 0) & (pv_jm1 + sub == here)
        vert_ok = slot_ok & (pv_j + g == here)
        horiz_ok = (j > 0) & (Smat[jnp.clip(r + 1, 0, N), jnp.maximum(j - 1, 0)]
                              + g == here)
        at_virtual = r < 0

        any_diag = jnp.any(diag_ok) & ~at_virtual
        any_vert = jnp.any(vert_ok) & ~at_virtual
        sel_d = jnp.argmax(diag_ok)
        sel_v = jnp.argmax(vert_ok)

        # priority: virtual-row insertion / diag / vert / horiz
        move = jnp.where(at_virtual, 3,
                         jnp.where(any_diag, 0, jnp.where(any_vert, 1, 3)))
        # move 0: diag (u, j-1) -> pred; 1: vert (u, -1) -> pred;
        # 3: horiz (-1, j-1) stay row
        new_r = jnp.where(move == 0, prow[sel_d] - 1,
                          jnp.where(move == 1, prow[sel_v] - 1, r))
        new_j = jnp.where((move == 0) | (move == 3), j - 1, j)
        node_e = jnp.where(move == 3, -1, u)
        pos_e = jnp.where(move == 1, -1, j - 1)
        k2 = k - 1
        pn = pn.at[k2].set(node_e)
        pp = pp.at[k2].set(pos_e)
        return new_r, new_j, k2, pn, pp

    r0 = jnp.where(state.node_count > 0, r_end, jnp.int32(-1))
    _, _, k, pn, pp = jax.lax.while_loop(
        cond, body, (r0, slen.astype(jnp.int32), jnp.int32(TL), pn0, pp0))
    return pn, pp, k, band_ok


# ------------------------------------------------------------ add alignment

def add_alignment(state: PoaState, path_node, path_pos, seq, weights,
                  seq_idx, bs: BatchSize, path_start=None):
    """Fold the traceback into the DAG (reference:
    cudapoa_add_alignment.cuh [U]); canonical rules from cpu/poa_oracle.py.

    path_start (the `start` from nw_traceback) skips the inert buffer prefix:
    the walk becomes a while_loop over the TRUE path length instead of a scan
    over the whole fixed-size buffer (~2.5x fewer sequential steps)."""
    N, P = state.pred.shape
    A = state.alig.shape[1]
    TL = path_node.shape[0]
    path_row = jnp.full(state.paths.shape[1], -1, jnp.int32)
    if path_start is not None:
        path_node = jnp.roll(path_node, -path_start)
        path_pos = jnp.roll(path_pos, -path_start)
        n_steps = TL - path_start
    else:
        n_steps = TL

    def step(carry, x):
        st, prev, prev_pos, prow = carry
        node, pos = x
        inert = (node == -2) | ((node == -1) & (pos == -1))
        is_del = (node >= 0) & (pos == -1)
        consume = ~inert & ~is_del

        b = _padget(seq, pos, -1)
        w = _padget(weights, pos, 0)

        # --- choose / create target node
        node_c = jnp.clip(node, 0, N - 1)
        same = (state_base(st)[node_c] == b) & (b >= 0) & (node >= 0)
        cands = st.alig[node_c]                      # (A,)
        cand_ok = (jnp.arange(A) < st.nalig[node_c]) & (b >= 0)
        cand_match = cand_ok & (_padget(st.base, cands, -2) == b)
        any_cand = jnp.any(cand_match)
        cand_sel = cands[jnp.argmax(cand_match)]

        need_new = consume & ~((node >= 0) & (same | any_cand))
        new_id = jnp.clip(st.node_count, 0, N - 1)
        overflow_node = need_new & (st.node_count >= bs.max_nodes_per_window)

        target = jnp.where(~consume, -1,
                  jnp.where((node >= 0) & same, node,
                   jnp.where((node >= 0) & any_cand, cand_sel, new_id)))
        target_c = jnp.clip(target, 0, N - 1)

        # create node (masked)
        base = jnp.where(need_new, st.base.at[new_id].set(b), st.base)
        # aligned-clique linking for branch nodes (node >= 0, no match)
        link = need_new & (node >= 0)
        group_sz = st.nalig[node_c] + 1              # node + its aligned
        overflow_clique = link & (group_sz > A)
        members = jnp.where(jnp.arange(A) < st.nalig[node_c], cands, -1)
        members = jnp.concatenate([jnp.array([node_c], jnp.int32),
                                   members])[: A + 1]  # (A+1,) node first
        # new node's aligned list = sorted(group) = sorted members (asc)
        new_alig = jnp.sort(jnp.where(members >= 0, members, 2**30))[:A]
        new_alig = jnp.where(new_alig >= 2**30, -1, new_alig)
        alig = jnp.where(link, st.alig.at[new_id].set(new_alig), st.alig)
        nalig = jnp.where(link,
                          st.nalig.at[new_id].set(jnp.minimum(group_sz, A)),
                          st.nalig)
        # append new_id to each member's aligned list (new_id is max -> end).
        # members are distinct, so one 2D drop-scatter replaces the loop.
        mc = jnp.clip(members, 0, N - 1)                  # (A+1,)
        mslots = jnp.clip(jnp.take(nalig, mc), 0, A - 1)
        mdo = link & (members >= 0) & (jnp.take(nalig, mc) < A)
        mrows = jnp.where(mdo, mc, N)                     # N -> dropped
        alig = alig.at[mrows, mslots].set(new_id, mode="drop")
        nalig = nalig.at[mrows].add(1, mode="drop")

        cov = jnp.where(consume, st.cov.at[target_c].add(w), st.cov)
        node_count = jnp.where(need_new & ~overflow_node,
                               st.node_count + 1, st.node_count)

        # --- edge prev -> target
        ew = jnp.minimum(_padget(weights, prev_pos, 0), w)
        has_edge_from = (prev >= 0) & consume
        prev_c = jnp.clip(prev, 0, N - 1)
        plist = st.pred[target_c]                     # before any edge update
        slot_ok = jnp.arange(P) < st.npred[target_c]
        exist = slot_ok & (plist == prev_c)
        any_exist = jnp.any(exist) & has_edge_from
        exist_slot = jnp.argmax(exist)
        predw = jnp.where(any_exist,
                          st.predw.at[target_c, exist_slot].add(ew), st.predw)
        # insert new pred keeping ascending order
        ins = has_edge_from & ~any_exist
        npred_t = st.npred[target_c]
        overflow_edge = ins & (npred_t >= P)
        pos_ins = jnp.sum(slot_ok & (plist < prev_c)).astype(jnp.int32)
        ar = jnp.arange(P)
        old_p = plist
        old_w = st.predw[target_c]
        new_p = jnp.where(ar < pos_ins, old_p,
                 jnp.where(ar == pos_ins, prev_c,
                           _padget(old_p, ar - 1, -1)))
        new_w = jnp.where(ar < pos_ins, old_w,
                 jnp.where(ar == pos_ins, ew, _padget(old_w, ar - 1, 0)))
        do_ins = ins & ~overflow_edge
        pred = jnp.where(do_ins, predw_set_row(st.pred, target_c, new_p),
                         st.pred)
        predw = jnp.where(do_ins, predw_set_row(predw, target_c, new_w),
                          predw)
        npred = jnp.where(do_ins, st.npred.at[target_c].set(npred_t + 1),
                          st.npred)
        nsucc = jnp.where(do_ins, st.nsucc.at[prev_c].add(1), st.nsucc)

        status = st.status
        status = jnp.where(
            (status == StatusType.SUCCESS) & overflow_node,
            jnp.int32(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE), status)
        status = jnp.where(
            (status == StatusType.SUCCESS) & overflow_clique,
            jnp.int32(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE), status)
        status = jnp.where(
            (status == StatusType.SUCCESS) & overflow_edge,
            jnp.int32(StatusType.EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE), status)

        prow = jnp.where(consume,
                         prow.at[jnp.clip(pos, 0, prow.shape[0] - 1)]
                         .set(target), prow)
        new_prev = jnp.where(consume, target, prev)
        new_prev_pos = jnp.where(consume, pos, prev_pos)
        st2 = st._replace(base=base, cov=cov, npred=npred, pred=pred,
                          predw=predw, nsucc=nsucc, nalig=nalig, alig=alig,
                          node_count=node_count, status=status)
        return (st2, new_prev, new_prev_pos, prow), ()

    def wcond(c):
        return c[0] < n_steps

    def wbody(c):
        j, st, prev, prev_pos, prow = c
        (st, prev, prev_pos, prow), _ = step(
            (st, prev, prev_pos, prow), (path_node[j], path_pos[j]))
        return j + 1, st, prev, prev_pos, prow

    _, st, _, _, prow = jax.lax.while_loop(
        wcond, wbody,
        (jnp.int32(0), state, jnp.int32(-1), jnp.int32(-1), path_row))
    paths = st.paths.at[jnp.clip(seq_idx, 0, st.paths.shape[0] - 1)].set(prow)
    return st._replace(paths=paths)


def state_base(st: PoaState):
    return st.base


def predw_set_row(arr, row, values):
    return arr.at[row].set(values)


# -------------------------------------------------------------- consensus

def consensus(state: PoaState, order, rank, max_cons: int):
    """Heaviest-bundle consensus (reference:
    cudapoa_generate_consensus.cuh [U]).  Returns (codes (max_cons,) i32
    with -1 padding, coverage (max_cons,) i32, length).

    Scores are solved by FIXPOINT RELAXATION over all nodes at once (the
    same trick as topsort) instead of a node-by-node scan: each sweep
    applies the oracle's lexicographic choice (edge weight, pred score,
    -pred index) to every node simultaneously; nodes at depth <= k are final
    after k sweeps, so the while_loop converges in graph-depth sweeps —
    far fewer loop steps than a 1-node-per-step scan (tiny-op step
    overhead).
    """
    N, P = state.pred.shape
    idx = jnp.arange(N, dtype=jnp.int32)
    act = idx < state.node_count
    slot_ok = (jnp.arange(P)[None, :] < state.npred[:, None]) & act[:, None]
    predc = jnp.clip(state.pred, 0, N - 1)
    w = jnp.where(slot_ok, state.predw, NEG)
    wmax = jnp.max(w, axis=1)                               # (N,)
    tie1 = slot_ok & (w == wmax[:, None])
    has = state.npred > 0

    def lex_scores(score):
        ps = jnp.where(tie1, jnp.take(score, predc.reshape(-1)
                                      ).reshape(N, P), NEG)
        smax = jnp.max(ps, axis=1)
        new = jnp.where(has, wmax + smax, 0)
        return jnp.where(act, new, NEG), ps, smax

    def cond(c):
        _, changed, it = c
        return changed & (it < N + 2)

    def body(c):
        score, _, it = c
        new, _, _ = lex_scores(score)
        return new, jnp.any(new != score), it + 1

    score0 = jnp.where(act & ~has, 0, NEG)
    score, _, _ = jax.lax.while_loop(
        cond, body, (score0, jnp.bool_(True), jnp.int32(0)))

    # best_pred in one vectorized pass (slots are sorted by pred index, so
    # the first slot achieving the lexicographic max is the smallest pred)
    _, ps, smax = lex_scores(score)
    tie2 = tie1 & (ps == smax[:, None])
    sel = jnp.argmax(tie2, axis=1)
    best_pred = jnp.where(
        act & has, jnp.take_along_axis(state.pred, sel[:, None], axis=1)[:, 0],
        -1)

    # end node: max score, tie -> smallest rank (two-stage, overflow-safe;
    # rank is indexed by node id, so argmin returns the node id directly)
    smax_all = jnp.max(jnp.where(act, score, NEG))
    tie_end = act & (score == smax_all)
    end = jnp.argmin(jnp.where(tie_end, rank, jnp.int32(2**30))
                     ).astype(jnp.int32)

    # backtrack: write reversed into buffer end
    buf_n = jnp.full(max_cons, -1, jnp.int32)

    def cond(c):
        u, k, _ = c
        return (u >= 0) & (k > 0)

    def body(c):
        u, k, buf = c
        buf = buf.at[k - 1].set(u)
        return _padget(best_pred, u, -1), k - 1, buf

    u0 = jnp.where(state.node_count > 0, end, jnp.int32(-1))
    _, k, buf = jax.lax.while_loop(cond, body,
                                   (u0, jnp.int32(max_cons), buf_n))
    length = max_cons - k
    # shift to front: roll by -k
    buf = jnp.roll(buf, -k)
    codes = jnp.where(jnp.arange(max_cons) < length,
                      _padget(state.base, buf, -1), -1)
    covs = jnp.where(jnp.arange(max_cons) < length,
                     _padget(state.cov, buf, 0), 0)
    return codes, covs, length


# -------------------------------------------------------------------- MSA

def msa_columns(state: PoaState, order, rank):
    """Column id per node (aligned cliques share a column; column =
    1 + max over group preds' columns, assigned at first member in top
    order).  Returns (col (N,), n_cols)."""
    N, P = state.pred.shape
    A = state.alig.shape[1]

    def step(col, r):
        u = order[r]
        act = r < state.node_count
        unassigned = _padget(col, u, 0) < 0
        group = jnp.concatenate([u[None], state.alig[jnp.clip(u, 0, N - 1)]])
        gok = jnp.concatenate([
            jnp.array([True]),
            jnp.arange(A) < state.nalig[jnp.clip(u, 0, N - 1)]])
        # preds of all group members
        gp = _padget(state.pred, group, -1)          # (A+1, P)
        gnp = _padget(state.npred, group, 0)         # (A+1,)
        pok = (jnp.arange(P)[None, :] < gnp[:, None]) & gok[:, None]
        pcols = jnp.where(pok, _padget(col, gp.reshape(-1), -1).reshape(gp.shape), -1)
        c = jnp.max(pcols) + 1
        do = act & unassigned
        gidx = jnp.where(gok & do, group, N)       # N slots dropped
        col = col.at[gidx].set(c, mode="drop")
        return col, ()

    col0 = jnp.full(N, -1, jnp.int32)
    col, _ = jax.lax.scan(step, col0, jnp.arange(N, dtype=jnp.int32))
    n_cols = jnp.max(jnp.where(jnp.arange(N) < state.node_count, col, -1)) + 1
    return col, n_cols


def msa_rows(state: PoaState, col, n_cols, max_cols: int):
    """Per-sequence gapped rows: codes (S, max_cols) i32, -1 = gap."""

    def one(path):
        c = _padget(col, path, -1)
        c = jnp.where((path >= 0) & (c >= 0), c, max_cols)   # dropped
        b = _padget(state.base, path, -1)
        # two nodes of one path can share a column; the later one wins, as
        # in the oracle's in-order writes.  A plain scatter of duplicate
        # indices leaves the winner to the backend (a GPU picks either), so
        # scatter the path position with max and gather the base after.
        last = jnp.full(max_cols, -1, jnp.int32).at[c].max(
            jnp.arange(path.shape[0], dtype=jnp.int32), mode="drop")
        return jnp.where(last >= 0, b[jnp.maximum(last, 0)], -1)

    return jax.vmap(one)(state.paths)
