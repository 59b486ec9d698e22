"""Batched POA — the cudapoa equivalent.

API mirrors the reference Batch surface (reference:
cudapoa/include/claragenomics/cudapoa/batch.hpp [U]): ``create_batch(...)`` ->
``Batch`` with ``add_poa_group`` / ``generate_poa`` / ``get_consensus`` /
``get_msa`` / ``get_graphs`` / ``reset``; per-window StatusType discipline.

Device behavior: all windows of the batch run as ONE vmapped XLA program
(the reference launches one CUDA block per window); per-window work is a
lax.scan over the window's sequences, each step = topsort + graph-NW +
traceback + masked graph extension (ops/poa_ops.py).
"""

import functools
import itertools

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import BatchSize, PoaScores
from ..core.status import OutputType, StatusType
from ..ops import poa_ops
from ..utils.genomeutils import BASES, encode


def _graph_scan(bs: BatchSize, sc: PoaScores, banded: bool,
                seqs, weights, lens, n_seqs):
    """The per-window sequence loop (topsort -> graph-NW -> traceback ->
    extension per added sequence).  Returns (state, level)."""
    N = bs.padded_nodes
    S = bs.max_sequences_per_poa
    TL = N + bs.padded_seq
    state = poa_ops.init_state(bs, seqs[0], weights[0], lens[0])
    level0 = jnp.where(jnp.arange(N) < lens[0],
                       jnp.arange(N, dtype=jnp.int32), 0)

    def add_seq(carry, x):
        state, level = carry
        seq, w, slen, s_idx = x
        active = (s_idx < n_seqs) & (state.status == StatusType.SUCCESS)
        new_level, order, rank, ok = poa_ops.topsort(state, level, N + 2)
        Smat = poa_ops.graph_nw(state, order, rank, seq, slen, sc,
                                band_width=bs.band_width if banded else 0)
        pn, pp, k0, band_ok = poa_ops.nw_traceback(state, order, rank,
                                                   Smat, seq, slen, sc, TL)
        new_state = poa_ops.add_alignment(state, pn, pp, seq, w,
                                          s_idx, bs, path_start=k0)
        new_state = new_state._replace(status=jnp.where(
            ok, new_state.status,
            jnp.int32(StatusType.LOOP_COUNT_EXCEEDED_UPPER_BOUND)))
        # band failure: keep the last consistent graph (oracle rule 8),
        # only the sticky status advances
        new_state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(band_ok, a, b),
            new_state, state._replace(status=jnp.int32(
                StatusType.EXCEEDED_BAND_WIDTH)))
        state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(active, a, b), new_state, state)
        level = jnp.where(active, new_level, level)
        return (state, level), ()

    xs = (seqs[1:], weights[1:], lens[1:],
          jnp.arange(1, S, dtype=jnp.int32))
    (state, level), _ = jax.lax.scan(add_seq, (state, level0), xs)
    return state, level


@functools.lru_cache(maxsize=16)
def _build_program(bs: BatchSize, sc: PoaScores, msa: bool,
                   banded: bool = False):
    N = bs.padded_nodes
    S = bs.max_sequences_per_poa
    MC = bs.max_consensus_size

    def run_window(seqs, weights, lens, n_seqs):
        state, level = _graph_scan(bs, sc, banded, seqs, weights, lens,
                                   n_seqs)
        _, order, rank, _ = poa_ops.topsort(state, level, N + 2)
        codes, covs, length = poa_ops.consensus(state, order, rank, MC)
        if msa:
            col, n_cols = poa_ops.msa_columns(state, order, rank)
            rows = poa_ops.msa_rows(state, col, n_cols, N)
        else:
            rows = jnp.zeros((S, 1), jnp.int32)
            n_cols = jnp.int32(0)
        return codes, covs, length, rows, n_cols, state.status

    return jax.jit(jax.vmap(run_window))


@functools.lru_cache(maxsize=4)
def _build_graph_program(bs: BatchSize, sc: PoaScores, banded: bool = False):
    """Exports the final DEVICE graph arrays (base/coverage/pred lists) —
    the debug surface behind Batch.get_graphs."""

    def run_window(seqs, weights, lens, n_seqs):
        state, _ = _graph_scan(bs, sc, banded, seqs, weights, lens, n_seqs)
        return (state.base, state.cov, state.npred, state.pred,
                state.predw, state.node_count, state.status)

    return jax.jit(jax.vmap(run_window))


class Batch:
    """POA batch over padded windows (reference: cudapoa Batch [U])."""

    _next_id = itertools.count()

    def __init__(self, batch_size: BatchSize | None = None,
                 scores: PoaScores | None = None,
                 output_mask: int = OutputType.CONSENSUS,
                 max_poas: int = 1024, banded_alignment: bool = False,
                 mesh=None):
        self.batch_size = batch_size or BatchSize()
        self.scores = scores or PoaScores()
        self.output_mask = OutputType(output_mask)
        self.max_poas = max_poas
        self.banded_alignment = banded_alignment
        self.mesh = mesh  # optional Mesh: windows sharded over 'data' axis
        self._batch_id = next(Batch._next_id)  # itertools.count is atomic
        self._groups: list[tuple[list[str], list[list[int]]]] = []
        self._host_status: list[StatusType] = []
        self._out = None        # host (numpy) outputs, decoded lazily
        self._out_dev = None    # in-flight device outputs (async dispatch)

    # ------------------------------------------------------------------ API

    def add_poa_group(self, seqs: list[str],
                      weights: list[list[int]] | None = None) -> StatusType:
        bs = self.batch_size
        if len(self._groups) >= self.max_poas:
            return StatusType.EXCEEDED_MAXIMUM_POAS
        status = StatusType.SUCCESS
        if len(seqs) > bs.max_sequences_per_poa:
            status = StatusType.EXCEEDED_MAXIMUM_SEQUENCES_PER_POA
        elif any(len(s) > bs.max_sequence_size for s in seqs):
            status = StatusType.EXCEEDED_MAXIMUM_SEQUENCE_SIZE
        if weights is None:
            weights = [[1] * len(s) for s in seqs]
        self._groups.append((seqs, weights))
        self._host_status.append(status)
        self._out = self._out_dev = None
        return status

    def get_total_poas(self) -> int:
        return len(self._groups)

    def batch_id(self) -> int:
        """Unique id per Batch instance (reference: Batch::batch_id [U])."""
        return self._batch_id

    def generate_poa(self) -> None:
        """Pack + dispatch the window batch.  NON-BLOCKING on an async
        backend (JAX dispatch): device outputs are materialized lazily by
        the first get_consensus/get_msa call, so a caller can dispatch
        batch i+1 while batch i computes (the stream-overlap axis of the
        reference's multibatch benchmark, cudapoa/benchmarks/multibatch
        [U] — see models/correct._polish_windows)."""
        from ..utils.profiling import trace_range
        bs = self.batch_size
        S, L = bs.max_sequences_per_poa, bs.padded_seq
        W = len(self._groups)
        if W == 0:
            self._out = ([],) * 6
            return
        with trace_range("poa.generate"):
            self._generate(bs, S, L, W)

    def _pack_arrays(self, bs, S, L, W):
        Wp = max(8, 1 << (W - 1).bit_length())
        # seqs ship as int8 (codes are -1..3) and weights as uint8 when
        # they fit (the correction path's are all 1), a quarter of the
        # int32 bytes; _generate casts to int32 on the device.
        seqs = np.full((Wp, S, L), -1, dtype=np.int8)
        weights = np.zeros((Wp, S, L), dtype=np.int32)
        lens = np.zeros((Wp, S), dtype=np.int32)
        n_seqs = np.zeros(Wp, dtype=np.int32)
        for wi, ((group, wts), hstat) in enumerate(
                zip(self._groups, self._host_status)):
            if hstat != StatusType.SUCCESS:
                continue  # leave as empty window; host status wins at decode
            n_seqs[wi] = len(group)
            for si, (s, wt) in enumerate(zip(group, wts)):
                seqs[wi, si, : len(s)] = encode(s)
                weights[wi, si, : len(s)] = wt
                lens[wi, si] = len(s)
        if weights.size and 0 <= weights.min() and weights.max() <= 255:
            weights = weights.astype(np.uint8)
        return seqs, weights, lens, n_seqs

    def _generate(self, bs, S, L, W) -> None:
        seqs, weights, lens, n_seqs = self._pack_arrays(bs, S, L, W)
        msa = bool(self.output_mask & OutputType.MSA)
        program = _build_program(self.batch_size, self.scores, msa,
                                 self.banded_alignment)
        # transfer the small dtypes, cast to int32 on the device (free
        # next to the POA scan)
        seqs_d = jnp.asarray(seqs).astype(jnp.int32)
        weights_d = jnp.asarray(weights).astype(jnp.int32)
        if self.mesh is not None and self.mesh.shape.get("data", 1) > 1:
            # window dim sharded over the mesh 'data' axis; merging is
            # concatenation so N-device == 1-device bit-for-bit
            from ..parallel.shard import sharded_poa
            self._out_dev = sharded_poa(
                program, seqs_d, weights_d, lens, n_seqs, self.mesh)
            return
        self._out_dev = program(seqs_d, weights_d,
                                jnp.asarray(lens), jnp.asarray(n_seqs))

    def _ensure(self):
        if self._out is None:
            if self._out_dev is None:
                self.generate_poa()
            if self._out is None:  # W > 0: materialize the device outputs
                self._out = tuple(np.asarray(o) for o in self._out_dev)
                self._out_dev = None

    def get_consensus(self):
        """Returns (consensus list[str], coverage list[list[int]],
        statuses list[StatusType])."""
        self._ensure()
        codes, covs, lengths, _, _, dstat = self._out
        out_s, out_c, out_st = [], [], []
        for wi in range(len(self._groups)):
            st = self._host_status[wi]
            if st == StatusType.SUCCESS:
                st = StatusType(int(dstat[wi]))
            if st != StatusType.SUCCESS:
                out_s.append("")
                out_c.append([])
                out_st.append(st)
                continue
            n = int(lengths[wi])
            if n > self.batch_size.max_consensus_size:
                n = self.batch_size.max_consensus_size
            # negative codes are ambiguous-base (N) nodes, kept positionally
            out_s.append("".join(BASES[c] if c >= 0 else "N"
                                 for c in codes[wi, :n]))
            out_c.append([int(x) for x in covs[wi, :n]])
            out_st.append(StatusType.SUCCESS)
        return out_s, out_c, out_st

    def get_msa(self):
        """Returns (msa list[list[str]], statuses)."""
        if not (self.output_mask & OutputType.MSA):
            n = len(self._groups)
            return [[] for _ in range(n)], [StatusType.OUTPUT_TYPE_UNAVAILABLE] * n
        self._ensure()
        _, _, _, rows, n_cols, dstat = self._out
        out_m, out_st = [], []
        for wi in range(len(self._groups)):
            st = self._host_status[wi]
            if st == StatusType.SUCCESS:
                st = StatusType(int(dstat[wi]))
            if st != StatusType.SUCCESS:
                out_m.append([])
                out_st.append(st)
                continue
            nc = int(n_cols[wi])
            msa = []
            for si in range(len(self._groups[wi][0])):
                row = rows[wi, si, :nc]
                msa.append("".join(BASES[c] if c >= 0 else "-" for c in row))
            out_m.append(msa)
            out_st.append(StatusType.SUCCESS)
        return out_m, out_st

    def get_graphs(self):
        """DirectedGraph views of the DEVICE-computed POA graphs
        (reference: Batch::get_graphs [U]).

        The export runs the XLA graph program and reads back the final
        node/edge arrays — so the debug surface shows what the device
        actually built, not an oracle re-derivation (they are equal for
        successful windows by the oracle-equality contract, which tests
        assert via DOT comparison).  Failed windows export None."""
        from ..utils.graph import DirectedGraph
        bs = self.batch_size
        S, L = bs.max_sequences_per_poa, bs.padded_seq
        W = len(self._groups)
        if W == 0:
            return []
        arrays = self._pack_arrays(bs, S, L, W)
        prog = _build_graph_program(bs, self.scores, self.banded_alignment)
        base, cov, npred, pred, predw, ncount, dstat = (
            np.asarray(x) for x in prog(*map(jnp.asarray, arrays)))
        graphs = []
        for wi in range(W):
            st = self._host_status[wi]
            if st == StatusType.SUCCESS:
                st = StatusType(int(dstat[wi]))
            if st != StatusType.SUCCESS:
                graphs.append(None)
                continue
            g = DirectedGraph()
            for u in range(int(ncount[wi])):
                g.set_node_label(
                    u, f"{BASES[base[wi, u]]}:{int(cov[wi, u])}")
                for p in range(int(npred[wi, u])):
                    g.add_edge(int(pred[wi, u, p]), u,
                               int(predw[wi, u, p]))
            graphs.append(g)
        return graphs

    def reset(self) -> None:
        self._groups.clear()
        self._host_status.clear()
        self._out = self._out_dev = None


def create_batch(batch_size: BatchSize | None = None,
                 scores: PoaScores | None = None,
                 output_mask: int = OutputType.CONSENSUS,
                 max_poas: int = 1024,
                 gap_score: int | None = None,
                 mismatch_score: int | None = None,
                 match_score: int | None = None,
                 banded_alignment: bool = False, mesh=None) -> Batch:
    """Factory mirroring the reference create_batch [U] (incl. its
    banded_alignment bool; band width comes from BatchSize.band_width).
    mesh: optional Mesh — windows are sharded over its 'data' axis."""
    if scores is None and any(v is not None for v in
                              (gap_score, mismatch_score, match_score)):
        d = PoaScores()
        scores = PoaScores(
            match_score=match_score if match_score is not None else d.match_score,
            mismatch_score=mismatch_score if mismatch_score is not None else d.mismatch_score,
            gap_score=gap_score if gap_score is not None else d.gap_score)
    return Batch(batch_size, scores, output_mask, max_poas, banded_alignment,
                 mesh)
