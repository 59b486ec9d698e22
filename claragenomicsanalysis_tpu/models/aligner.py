"""Batched pairwise global aligner — the cudaaligner equivalent.

API mirrors the reference's Aligner/Alignment surface (reference:
cudaaligner/include/claragenomics/cudaaligner/aligner.hpp, alignment.hpp [U]):
``create_aligner(...)`` -> ``Aligner`` with ``add_alignment`` /
``align_all`` / ``get_alignments`` / ``reset``; each result exposes the edit
path, CIGAR, pretty 3-line view and a per-problem StatusType.

Behavior differences from the reference (by design):
- ``align_all`` dispatches ONE jitted XLA program over the whole padded batch
  (no streams; JAX async dispatch overlaps host packing with device compute).
- Problems that exceed static limits get a status and an empty result instead
  of being rejected at add time where the reference's behavior was the same
  (add_alignment returns the would-be status too, like the reference).

Algorithms:
- ``ukkonen`` (default): banded NW via ops.banded (the Triton kernel on a GPU,
  the XLA scan twin elsewhere).
- ``myers``: Myers bit-vector edit distance with banded traceback
  (ops.myers), for pairs whose edit distance fits the band at traceback time.
- ``hirschberg-myers``: linear-memory divide and conquer for long pairs
  (align.hirschberg).
"""

from dataclasses import dataclass, field

import numpy as np

from ..core.config import AlignerConfig
from ..core.status import AlignmentType, CIGAR_OP_COMPACT, StatusType
from ..cpu import nw_oracle
from ..utils.genomeutils import encode


@dataclass
class Alignment:
    """One alignment result (reference: Alignment interface [U])."""

    query: str
    target: str
    status: StatusType
    alignment_type: AlignmentType = AlignmentType.GLOBAL_ALIGNMENT
    path: list[int] = field(default_factory=list)   # AlignmentState codes
    edit_distance: int = -1

    def get_query(self) -> str:
        return self.query

    def get_target(self) -> str:
        return self.target

    def get_alignment(self) -> list[int]:
        return self.path

    def convert_to_cigar(self, extended: bool = False) -> str:
        return nw_oracle.path_to_cigar(self.path, extended=extended)

    def format_alignment(self, width: int = 80) -> str:
        return nw_oracle.format_alignment(self.path, self.query, self.target,
                                          width)


class Aligner:
    """Batched global aligner over statically-shaped device arrays."""

    def __init__(self, config: AlignerConfig, algorithm: str = "ukkonen",
                 backend: str = "auto", mesh=None,
                 sp_min_len: int | None = None):
        if algorithm not in ("ukkonen", "myers", "hirschberg-myers",
                             "banded-escalate"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        from ..ops.banded import check_backend
        check_backend(backend)
        self.config = config
        self.algorithm = algorithm
        self.backend = backend
        # hirschberg-myers only: levels with padded target >= sp_min_len
        # compute their bottom rows on the mesh's 'sp' ring-wavefront axis
        self.mesh = mesh
        self.sp_min_len = sp_min_len
        self._queries: list[str] = []
        self._targets: list[str] = []
        self._results: list[Alignment] | None = None

    # ------------------------------------------------------------------ API

    def add_alignment(self, query: str, target: str) -> StatusType:
        cfg = self.config
        if len(self._queries) >= cfg.max_alignments:
            return StatusType.EXCEEDED_MAX_ALIGNMENTS
        if len(query) > cfg.max_query_length or len(target) > cfg.max_target_length:
            # keep the slot so results stay index-aligned, mark it failed
            self._queries.append(query)
            self._targets.append(target)
            self._results = None
            return StatusType.EXCEEDED_MAX_LENGTH
        self._queries.append(query)
        self._targets.append(target)
        self._results = None
        return StatusType.SUCCESS

    def align_all(self) -> None:
        self._results = self._run_batch()

    def sync_alignments(self) -> None:
        if self._results is None:
            self.align_all()

    def get_alignments(self) -> list[Alignment]:
        self.sync_alignments()
        assert self._results is not None
        return self._results

    def reset(self) -> None:
        self._queries.clear()
        self._targets.clear()
        self._results = None

    # ------------------------------------------------------------ internals

    def _pack(self):
        """Pack to padded arrays; the batch dim is bucketed to the next power
        of two so repeated batches of similar size reuse one XLA executable
        (the analog of the reference's fixed-capacity device slabs)."""
        cfg = self.config
        B = len(self._queries)
        Bpad = max(8, 1 << (B - 1).bit_length())
        q = np.full((Bpad, cfg.padded_query_length), -1, dtype=np.int8)
        t = np.full((Bpad, cfg.padded_target_length), -1, dtype=np.int8)
        qlen = np.zeros(Bpad, dtype=np.int32)
        tlen = np.zeros(Bpad, dtype=np.int32)
        for b, (qs, ts) in enumerate(zip(self._queries, self._targets)):
            q[b] = encode(qs[: cfg.max_query_length], cfg.padded_query_length)
            t[b] = encode(ts[: cfg.max_target_length], cfg.padded_target_length)
            qlen[b] = min(len(qs), cfg.max_query_length)
            tlen[b] = min(len(ts), cfg.max_target_length)
        return q, qlen, t, tlen, B

    def _run_batch(self) -> list[Alignment]:
        from ..utils.profiling import trace_range
        if not self._queries:
            return []
        cfg = self.config
        with trace_range("aligner.pack"):
            q, qlen, t, tlen, B = self._pack()

        overlong = np.array(
            [len(qs) > cfg.max_query_length or len(ts) > cfg.max_target_length
             for qs, ts in zip(self._queries, self._targets)])
        with trace_range(f"aligner.{self.algorithm}"):
            if self.algorithm == "hirschberg-myers":
                from ..align.hirschberg import hirschberg_align_batch
                paths, dists, statuses = hirschberg_align_batch(
                    self._queries, self._targets, cfg, mesh=self.mesh,
                    sp_min_len=self.sp_min_len, backend=self.backend)
            elif self.algorithm == "myers":
                from ..align.myers_aligner import myers_align_batch
                paths, dists, statuses = myers_align_batch(
                    q, qlen, t, tlen, cfg, backend=self.backend,
                    queries=self._queries, targets=self._targets)
            elif self.algorithm == "banded-escalate":
                from ..align.myers_aligner import banded_escalate_align_batch
                paths, dists, statuses = banded_escalate_align_batch(
                    q, qlen, t, tlen, cfg, backend=self.backend,
                    queries=self._queries, targets=self._targets)
            else:
                paths, dists, statuses = self._run_ukkonen(q, qlen, t, tlen)

        out = []
        for b in range(B):
            status = StatusType(int(statuses[b]))
            if overlong[b]:
                status = StatusType.EXCEEDED_MAX_LENGTH
            ok = status == StatusType.SUCCESS
            out.append(Alignment(
                query=self._queries[b], target=self._targets[b],
                status=status,
                path=paths[b] if ok else [],
                edit_distance=int(dists[b]) if ok else -1,
            ))
        return out

    def _run_ukkonen(self, q, qlen, t, tlen):
        """Banded NW with the reference's adaptive Ukkonen band
        p + |lq - lt| (reference: ukkonen_gpu.cu band sizing [U]): a pair
        whose lengths differ by more than the configured radius is still
        alignable — the band is widened per pair.  Pairs are bucketed by
        power-of-two widening so only O(log L) executables exist."""
        from ..ops import banded, nw_band
        cfg = self.config
        mesh_dp = (self.mesh is not None
                   and self.mesh.shape.get("data", 1) > 1)
        if mesh_dp:
            # batch sharded over the mesh 'data' axis (bit-identical merge
            # by construction; the sharded program is the XLA scan twin)
            from ..parallel.shard import sharded_banded_nw

            def fn(qq, ql, tt, tl, r):
                sc, tb = sharded_banded_nw(qq, ql, tt, tl, r, self.mesh)
                return sc, banded.Traceback("xla", tb)
        else:
            def fn(qq, ql, tt, tl, r):
                return banded.banded_nw(qq, ql, tt, tl, r, self.backend)
        qlen = np.asarray(qlen)
        tlen = np.asarray(tlen)
        B = q.shape[0]
        dl = np.abs(qlen - tlen)

        buckets: dict[int, list[int]] = {}
        for b in range(B):
            extra = 0 if dl[b] == 0 else max(8, 1 << int(dl[b] - 1).bit_length())
            buckets.setdefault(cfg.band_radius + extra, []).append(b)

        paths: list[list[int]] = [[] for _ in range(B)]
        scores = np.zeros(B, dtype=np.int32)
        from dataclasses import replace as dc_replace

        # the per-dispatch device budget bounds traceback bytes in flight
        # when the adaptive band is wide; plan_aligner_batch turns it into
        # a problems-per-batch count (the reference's
        # batched_device_matrices slab arithmetic)
        from ..core.bufferplan import dispatch_bytes, plan_aligner_batch
        for r, idxs in sorted(buckets.items()):
            plan = plan_aligner_batch(dc_replace(cfg, band_radius=r),
                                      dispatch_bytes())
            chunk = plan.problems_per_batch
            for s0 in range(0, len(idxs), chunk):
                sel = np.array(idxs[s0: s0 + chunk])
                rows = banded.pow2_rows(sel)
                sc, tb = fn(q[rows], qlen[rows], t[rows], tlen[rows], r)
                scores[sel] = np.asarray(sc)[: len(sel)]
                sub = banded.traceback_paths(tb, qlen[rows], tlen[rows], r)
                for k, b in enumerate(sel):
                    paths[b] = sub[k]

        statuses = np.where(scores >= nw_band.INF,
                            int(StatusType.EXCEEDED_MAX_ALIGNMENT_DIFFERENCE),
                            int(StatusType.SUCCESS))
        return paths, scores, statuses


def create_aligner(max_query_length: int, max_target_length: int,
                   max_alignments: int,
                   alignment_type: AlignmentType = AlignmentType.GLOBAL_ALIGNMENT,
                   band_radius: int = 64, algorithm: str = "ukkonen",
                   backend: str = "auto", mesh=None,
                   sp_min_len: int | None = None) -> Aligner:
    """Factory mirroring the reference's create_aligner [U].

    backend: "auto" | "pallas" | "xla" kernel choice (ops/banded.py).
    mesh: with a 'data' axis > 1, ukkonen batches shard across devices;
    with an 'sp' axis > 1, hirschberg-myers levels too long for one
    device route to the ring-wavefront kernel automatically (threshold
    from core.bufferplan.myers_max_query_len; sp_min_len overrides it)."""
    if alignment_type != AlignmentType.GLOBAL_ALIGNMENT:
        raise ValueError("only global alignment is supported")
    cfg = AlignerConfig(max_query_length=max_query_length,
                        max_target_length=max_target_length,
                        max_alignments=max_alignments,
                        band_radius=band_radius)
    return Aligner(cfg, algorithm=algorithm, backend=backend, mesh=mesh,
                   sp_min_len=sp_min_len)
