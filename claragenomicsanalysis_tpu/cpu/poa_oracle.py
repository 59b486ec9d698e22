"""CPU partial-order-alignment oracle — the executable spec for models.poa.

Mirrors the reference's device pipeline (reference: cudapoa/src/
cudapoa_topsort.cuh, cudapoa_nw.cuh, cudapoa_add_alignment.cuh,
cudapoa_generate_consensus.cuh, cudapoa_generate_msa.cuh [U]) with fully
deterministic canonical rules (ours, documented here — the device implementation
must match these bit-for-bit):

1.  **Topological order**: level-based Kahn. level(u) = longest path length
    from any source; order = stable sort by (level, node index).
2.  **Graph-vs-sequence NW** (linear gap): rows = nodes in top order, cols =
    sequence positions.  Virtual source row: S[-1][j] = j * gap.
    S[u][j] = max( max_p S[p][j-1] + sub(u, s_j),
                   max_p S[p][j]   + gap,
                   S[u][j-1]       + gap )
    where p ranges over preds of u (virtual source if none) and
    sub = match_score / mismatch_score.
3.  **Alignment end**: max score at column L over *sink* nodes (no outgoing
    edges); tie -> smallest topological rank.
4.  **Traceback tie-break** at (u, j): diagonal first (pred achieving it with
    the smallest node index; preds are kept sorted ascending), then vertical
    (graph-node deletion, same pred order), then horizontal (sequence
    insertion).
5.  **Graph extension**: matches reuse the node; mismatches reuse an aligned
    node with the same base (smallest index) or append a new node joined to
    the full aligned clique; insertions append an unaligned node.  Edge
    weights accumulate min(base_weight_prev, base_weight_cur) per traversing
    read (default weights 1); node coverage accumulates the base weight.
6.  **Consensus** (heaviest bundle): in top order,
    best_pred(u) = argmax over incoming edges (weight, score[pred], -pred);
    score(u) = score(best_pred) + weight(edge), 0 at sources.  Consensus path
    backtracks from argmax over all nodes of (score, -rank).  Per-position
    coverage = node coverage.
7.  **MSA columns**: aligned cliques share a column; column(group) =
    1 + max over preds of all group members of column(pred), assigned in top
    order; rows emitted by replaying each read's stored node path.
8.  **Static banding** (reference: cudapoa_nw_banded.cuh [U]; exact banding
    rule is OURS, documented here): with ``banded=True`` the NW of rule 2 only
    computes columns j with |j - c(r)| <= band_width // 2, where
    c(r) = ((r + 1) * L) // (node_count + 1) for the row of topological rank
    r; out-of-band cells are NEG.  If the best in-band sink score at column L
    is <= NEG/2 there is no global path inside the band: the window gets
    StatusType.EXCEEDED_BAND_WIDTH and keeps its last consistent state.

Static limits (BatchSize) are enforced IDENTICALLY to the device version:
exceeding max nodes / preds / aligned-links yields the corresponding
StatusType and the window keeps its last consistent state.
"""

from dataclasses import dataclass, field

import numpy as np

from ..core.config import BatchSize, PoaScores
from ..core.status import StatusType
from ..utils.genomeutils import BASES


@dataclass
class PoaGraph:
    """Adjacency-list POA graph (host oracle form).

    The device twin stores the same information as padded SoA arrays
    (models/poa.py); field names are kept parallel on purpose.
    """

    batch_size: BatchSize = field(default_factory=BatchSize)
    scores: PoaScores = field(default_factory=PoaScores)
    banded: bool = False
    node_base: list[int] = field(default_factory=list)
    node_coverage: list[int] = field(default_factory=list)
    preds: list[list[int]] = field(default_factory=list)        # sorted asc
    pred_weights: list[list[int]] = field(default_factory=list)  # parallel
    succs: list[list[int]] = field(default_factory=list)        # sorted asc
    aligned: list[list[int]] = field(default_factory=list)      # sorted asc
    seq_paths: list[list[int]] = field(default_factory=list)    # per read
    seq_weights_sum: list[int] = field(default_factory=list)
    status: int = int(StatusType.SUCCESS)

    # ------------------------------------------------------------------ build

    @property
    def node_count(self) -> int:
        return len(self.node_base)

    def _new_node(self, base: int, weight: int) -> int:
        if self.node_count >= self.batch_size.max_nodes_per_window:
            raise _Overflow(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE)
        self.node_base.append(int(base))
        self.node_coverage.append(int(weight))
        self.preds.append([])
        self.pred_weights.append([])
        self.succs.append([])
        self.aligned.append([])
        return self.node_count - 1

    def _add_edge(self, u: int, v: int, w: int) -> None:
        pl = self.preds[v]
        if u in pl:
            self.pred_weights[v][pl.index(u)] += w
            return
        if len(pl) >= self.batch_size.max_pred_per_node:
            raise _Overflow(StatusType.EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE)
        pos = int(np.searchsorted(np.array(pl, dtype=np.int64), u)) if pl else 0
        pl.insert(pos, u)
        self.pred_weights[v].insert(pos, w)
        sl = self.succs[u]
        spos = int(np.searchsorted(np.array(sl, dtype=np.int64), v)) if sl else 0
        sl.insert(spos, v)

    def _link_aligned(self, new: int, to: int) -> None:
        """Join `new` into the aligned clique of `to`."""
        group = [to] + list(self.aligned[to])
        if len(group) >= self.batch_size.max_aligned_per_node + 1:
            raise _Overflow(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE)
        for g in group:
            self.aligned[g] = sorted(self.aligned[g] + [new])
        self.aligned[new] = sorted(group)

    # -------------------------------------------------------------- topsort

    def topological_order(self) -> list[int]:
        n = self.node_count
        level = [0] * n
        indeg = [len(self.preds[u]) for u in range(n)]
        ready = [u for u in range(n) if indeg[u] == 0]
        seen = 0
        while ready:
            nxt = []
            for u in ready:
                seen += 1
                for v in self.succs[u]:
                    level[v] = max(level[v], level[u] + 1)
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        nxt.append(v)
            ready = sorted(nxt)
        if seen != n:
            raise _Overflow(StatusType.LOOP_COUNT_EXCEEDED_UPPER_BOUND)
        return sorted(range(n), key=lambda u: (level[u], u))

    # ------------------------------------------------------------------- NW

    def align_sequence(self, seq: list[int]) -> list[tuple[int, int]]:
        """Align encoded seq against the graph.  Returns the edit path as
        (node_id or -1, seq_pos or -1) pairs in forward order."""
        sc = self.scores
        order = self.topological_order()
        rank = {u: r for r, u in enumerate(order)}
        L = len(seq)
        NEG = -(2**30)
        # S[r+1][j]: score at node order[r], seq prefix j. Row 0 = virtual src.
        S = np.full((self.node_count + 1, L + 1), NEG, dtype=np.int64)
        S[0, :] = np.arange(L + 1, dtype=np.int64) * sc.gap_score
        hw = self.batch_size.band_width // 2 if self.banded else L + 1
        for r, u in enumerate(order):
            prows = [S[rank[p] + 1] for p in self.preds[u]] or [S[0]]
            pmax = np.max(np.stack(prows), axis=0)
            sarr = np.array(seq)
            sub = np.where((sarr == self.node_base[u]) & (sarr >= 0),
                           sc.match_score, sc.mismatch_score)
            c = ((r + 1) * L) // (self.node_count + 1)
            lo, hi = max(0, c - hw), min(L, c + hw)
            row = S[r + 1]
            if lo == 0:
                row[0] = pmax[0] + sc.gap_score
            diag_vert = np.maximum(pmax[:-1] + sub, pmax[1:] + sc.gap_score)
            # horizontal chain: running max against row[j-1] + gap
            for j in range(max(1, lo), hi + 1):
                row[j] = max(diag_vert[j - 1], row[j - 1] + sc.gap_score)
        # end cell: best sink at column L; tie -> smallest rank
        sinks = [r for r, u in enumerate(order) if not self.succs[u]]
        if not sinks:  # single-node graphs etc. — all nodes are sinks
            sinks = list(range(len(order)))
        best_r = max(sinks, key=lambda r: (S[r + 1, L], -r))
        if S[best_r + 1, L] <= NEG // 2:
            raise _Overflow(StatusType.EXCEEDED_BAND_WIDTH)
        # traceback
        path: list[tuple[int, int]] = []
        r, j = best_r, L
        while not (r < 0 and j == 0):
            if r < 0:  # virtual source row: consume remaining seq as inserts
                path.append((-1, j - 1))
                j -= 1
                continue
            u = order[r]
            here = S[r + 1, j]
            sub = (sc.match_score
                   if j > 0 and seq[j - 1] == self.node_base[u] and seq[j - 1] >= 0
                   else sc.mismatch_score)
            moved = False
            plist = self.preds[u] or [-1]
            if j > 0:  # diagonal
                for p in plist:
                    pr = rank[p] if p >= 0 else -1
                    if S[pr + 1, j - 1] + sub == here:
                        path.append((u, j - 1))
                        r, j = pr, j - 1
                        moved = True
                        break
            if moved:
                continue
            for p in plist:  # vertical: delete graph node u
                pr = rank[p] if p >= 0 else -1
                if S[pr + 1, j] + sc.gap_score == here:
                    path.append((u, -1))
                    r = pr
                    moved = True
                    break
            if moved:
                continue
            if j > 0 and S[r + 1, j - 1] + sc.gap_score == here:
                path.append((-1, j - 1))
                j -= 1
                continue
            raise AssertionError("POA traceback stuck")
        path.reverse()
        return path

    # ------------------------------------------------------------ extension

    def add_first_sequence(self, seq: list[int], weights: list[int]) -> None:
        prev = -1
        node_path = []
        for pos, b in enumerate(seq):
            u = self._new_node(b, weights[pos])
            if prev >= 0:
                self._add_edge(prev, u, min(weights[pos - 1], weights[pos]))
            prev = u
            node_path.append(u)
        self.seq_paths.append(node_path)
        self.seq_weights_sum.append(int(sum(weights)))

    def add_alignment(self, path: list[tuple[int, int]], seq: list[int],
                      weights: list[int]) -> None:
        prev = -1
        prev_pos = -1
        node_path: list[int] = [-1] * len(seq)
        for node, pos in path:
            if pos < 0:          # graph-node deletion: read skips the node
                continue
            b = seq[pos]
            w = weights[pos]
            if node >= 0:
                if self.node_base[node] == b and b >= 0:
                    target = node
                else:
                    target = -1
                    for a in self.aligned[node]:
                        if self.node_base[a] == b and b >= 0:
                            target = a
                            break
                    if target < 0:
                        target = self._new_node(b, 0)
                        self._link_aligned(target, node)
                self.node_coverage[target] += w
            else:                # insertion: brand-new unaligned node
                target = self._new_node(b, w)
            if prev >= 0:
                self._add_edge(prev, target, min(weights[prev_pos], w))
            prev, prev_pos = target, pos
            node_path[pos] = target
        self.seq_paths.append(node_path)
        self.seq_weights_sum.append(int(sum(weights)))

    # ------------------------------------------------------------ consensus

    def consensus(self) -> tuple[str, list[int]]:
        order = self.topological_order()
        rank = {u: r for r, u in enumerate(order)}
        n = self.node_count
        score = [0] * n
        best_pred = [-1] * n
        for u in order:
            best = None
            for p, w in zip(self.preds[u], self.pred_weights[u]):
                key = (w, score[p], -p)
                if best is None or key > best[0]:
                    best = (key, p)
            if best is not None:
                best_pred[u] = best[1]
                score[u] = best[0][1] + best[0][0]  # score[pred] + edge weight
        end = max(range(n), key=lambda u: (score[u], -rank[u]))
        rev_path = []
        u = end
        while u >= 0:
            rev_path.append(u)
            u = best_pred[u]
        path = rev_path[::-1]
        cons = "".join(BASES[self.node_base[u]] if self.node_base[u] >= 0
                       else "N" for u in path)
        cov = [self.node_coverage[u] for u in path]
        return cons, cov

    # ------------------------------------------------------------------ MSA

    def msa(self) -> list[str]:
        order = self.topological_order()
        col = [-1] * self.node_count
        next_col = 0
        for u in order:
            if col[u] >= 0:
                continue
            group = [u] + list(self.aligned[u])
            c = -1
            for g in group:
                for p in self.preds[g]:
                    c = max(c, col[p])
            c += 1
            # aligned groups must not collide with columns already used by
            # their own preds' groups; the max above guarantees monotonicity
            for g in group:
                col[g] = c
            next_col = max(next_col, c + 1)
        rows = []
        for node_path in self.seq_paths:
            row = ["-"] * next_col
            for u in node_path:
                if u >= 0:
                    # ambiguous-base (N) nodes render as '-': the device MSA
                    # arrays use -1 for BOTH gap and unknown base (a
                    # documented conflation — consensus keeps N exactly)
                    b = self.node_base[u]
                    row[col[u]] = BASES[b] if b >= 0 else "-"
            rows.append("".join(row))
        return rows

    def to_directed_graph(self):
        """Export for DOT debugging (SURVEY.md §2.1 graph utility)."""
        from ..utils.graph import DirectedGraph
        g = DirectedGraph()
        for u in range(self.node_count):
            g.set_node_label(u, f"{BASES[self.node_base[u]]}:{self.node_coverage[u]}")
            for p, w in zip(self.preds[u], self.pred_weights[u]):
                g.add_edge(p, u, w)
        return g


class _Overflow(Exception):
    def __init__(self, status: StatusType):
        self.status = int(status)


def poa(seqs: list[str], weights: list[list[int]] | None = None,
        batch_size: BatchSize | None = None,
        scores: PoaScores | None = None,
        output_msa: bool = False, banded: bool = False):
    """Full-window POA: returns (consensus, coverage, msa_rows, status)."""
    from ..utils.genomeutils import encode
    bs = batch_size or BatchSize()
    sc = scores or PoaScores()
    if len(seqs) > bs.max_sequences_per_poa:
        return "", [], [], int(StatusType.EXCEEDED_MAXIMUM_SEQUENCES_PER_POA)
    if any(len(s) > bs.max_sequence_size for s in seqs):
        return "", [], [], int(StatusType.EXCEEDED_MAXIMUM_SEQUENCE_SIZE)
    g = PoaGraph(batch_size=bs, scores=sc, banded=banded)
    try:
        for i, s in enumerate(seqs):
            codes = list(encode(s))
            w = weights[i] if weights else [1] * len(s)
            if i == 0:
                g.add_first_sequence(codes, w)
            else:
                path = g.align_sequence(codes)
                g.add_alignment(path, codes, w)
        cons, cov = g.consensus()
        rows = g.msa() if output_msa else []
        return cons, cov, rows, int(StatusType.SUCCESS)
    except _Overflow as e:
        return "", [], [], e.status
