"""Myers-scored alignment with banded traceback.

The reference's Myers aligner stores full PV/MV delta columns and backtraces
them on-device (reference: cudaaligner/src/myers_gpu.cu [U]).  This design
avoids materializing O(n*m/32) bit columns entirely:

1. run the Myers bit-vector kernel (ops/banded.myers_bottom_row) to get each pair's exact
   edit distance s;
2. re-run the canonical banded-NW kernel with band radius r >= s — except
   pairs whose banded traceback array would exceed the traceback budget
   (tb_budget), which route to the linear-memory Hirschberg driver instead
   (optimal but not canonical-tie-break paths; same caveat as the
   reference's Hirschberg path).

Any optimal path stays within |i-j| <= s (each off-diagonal step costs 1),
and for every cell on an optimal path the banded DP value equals the dense
value, while banded values elsewhere only increase — so the banded traceback
reproduces the *dense canonical* path exactly.  Pairs are bucketed by
power-of-two band radius so only O(log L) XLA executables exist.
"""

import numpy as np

from ..core.bufferplan import dispatch_bytes
from ..core.config import AlignerConfig
from ..core.status import StatusType
from ..ops import banded


#: per-problem traceback budget for the XLA twin, which runs where no
#: Triton kernel does (the CPU, and bands wider than
#: nw_diag_pallas.MAX_RADIUS on a GPU).  Its traceback is one uint8 per
#: cell of a band padded to 128 columns, at least 4x the kernel's 2-bit
#: diagonal layout.  The bound is fixed, not taken from the device:
#: Hirschberg's tie-breaks differ from the banded path's, so a bound that
#: moved with the machine would move the output.  A twin band on a GPU is
#: over 8k columns wide, so there every pair past 32 bases the twin would
#: take re-solves in linear memory through Hirschberg (the reference's
#: long-pair answer, hirschberg_myers_gpu.cu [U]).
TB_BYTES_PER_PROBLEM = 1 << 18


def tb_budget(kind: str) -> int:
    """Per-problem traceback budget of a kernel kind.  The Triton kernel's
    2-bit traceback lives in device memory and is decoded on the host, so
    its only bound is that one dispatch (core.bufferplan.dispatch_bytes)
    still holds the minimum chunk of 8 problems: about 120 MiB per problem
    on an 80 GB card at JAX's default memory share, where a 32 kb span at
    the kernel's widest pow2 radius (2,048) needs 32 MiB."""
    if kind == "pallas":
        return dispatch_bytes() // 8
    return TB_BYTES_PER_PROBLEM


def _infeasible(Lq: int, Lt: int, r: int, backend: str,
                interpret: bool) -> bool:
    kind = banded.nw_kind(backend, r, interpret)
    return banded.tb_bytes_per_problem(Lq, Lt, r, kind) > tb_budget(kind)


def _chunk(Lq: int, Lt: int, r: int, n: int, backend: str,
           interpret: bool) -> int:
    kind = banded.nw_kind(backend, r, interpret)
    per = max(1, banded.tb_bytes_per_problem(Lq, Lt, r, kind))
    return max(8, min(n, dispatch_bytes() // per))


def banded_escalate_align_batch(q, qlen, t, tlen, cfg: AlignerConfig,
                                backend: str = "auto",
                                queries: list[str] | None = None,
                                targets: list[str] | None = None,
                                interpret: bool = False):
    """Score-free variant of myers_align_batch: SKIP the O(Lq*Lt) Myers
    scoring pass and run the banded kernel directly at escalating pow2
    band radii.

    Soundness: the banded score s' always satisfies s' >= s (the dense
    edit distance), and if s' <= r then every dense-optimal path stays
    within |i - j| <= s <= r, so the band contains the dense optimum:
    s' == s and the banded traceback IS the canonical dense path —
    identical to what myers_align_batch would return.  Pairs with
    s' > r double the radius and redo; radii whose tracebacks exceed the
    budget route to Hirschberg (optimal paths, non-canonical tie-breaks —
    the same long-span contract as the Myers path).

    Why: the Myers pass costs Lq*Lt cells per pair regardless of
    similarity, while the banded pass it gates costs Lq*W(r), ~100x less
    on well-matched overlap spans.  The start
    radius pow2(max(|lq-lt|, (lq+lt)/12)) resolves ~10 %-divergent
    spans in one round."""
    from ..utils.profiling import trace_range
    B = q.shape[0]
    Lq, Lt = q.shape[1], t.shape[1]
    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)
    paths: list[list[int]] = [[] for _ in range(B)]
    dists = np.zeros(B, np.int32)
    statuses = np.full(B, int(StatusType.SUCCESS))

    def infeasible(r):
        return (queries is not None
                and _infeasible(Lq, Lt, r, backend, interpret))

    r_of: dict[int, int] = {}
    hirsch: list[int] = []
    for b in range(B):
        if qlen[b] == 0 and tlen[b] == 0:
            continue
        guess = max(abs(int(qlen[b]) - int(tlen[b])),
                    (int(qlen[b]) + int(tlen[b])) // 12, 8)
        r = 1 << int(guess - 1).bit_length()
        while infeasible(r) and r > 8:
            r //= 2        # start at the largest feasible radius instead
        if infeasible(r):
            hirsch.append(b)
        else:
            r_of[b] = r

    while r_of:
        buckets: dict[int, list[int]] = {}
        for b, r in r_of.items():
            buckets.setdefault(r, []).append(b)
        next_r: dict[int, int] = {}
        for r, idxs in sorted(buckets.items()):
            chunk = _chunk(Lq, Lt, r, len(idxs), backend, interpret)
            for s0 in range(0, len(idxs), chunk):
                sel = np.array(idxs[s0: s0 + chunk])
                rows = banded.pow2_rows(sel)
                with trace_range("aligner.banded_escalate.nw"):
                    sc, tb = banded.banded_nw(q[rows], qlen[rows], t[rows],
                                              tlen[rows], r, backend,
                                              interpret)
                    sc = np.asarray(sc)[: len(sel)]
                resolved = sc <= r
                if resolved.any():
                    with trace_range("aligner.banded_escalate.decode"):
                        sub = banded.traceback_paths(tb, qlen[rows],
                                                     tlen[rows], r)
                    for k, b in enumerate(sel):
                        if resolved[k]:
                            paths[b] = sub[k]
                            dists[b] = sc[k]
                for k, b in enumerate(sel):
                    if not resolved[k]:
                        r2 = 2 * r       # plain doubling: overshoot <= 2x
                        if infeasible(r2):
                            hirsch.append(int(b))
                        else:
                            next_r[int(b)] = r2
        r_of = next_r

    if hirsch:
        from .hirschberg import hirschberg_align_batch
        assert queries is not None and targets is not None, \
            "banded-escalate needs query/target strings for wide spans"
        with trace_range("aligner.myers.hirschberg"):
            h_paths, h_dists, _ = hirschberg_align_batch(
                [queries[b] for b in hirsch], [targets[b] for b in hirsch],
                cfg, backend=backend, interpret=interpret)
        for k, b in enumerate(hirsch):
            paths[b] = h_paths[k]
            dists[b] = h_dists[k]
    return paths, dists, statuses


def myers_align_batch(q, qlen, t, tlen, cfg: AlignerConfig,
                      backend: str = "auto",
                      queries: list[str] | None = None,
                      targets: list[str] | None = None,
                      interpret: bool = False):
    """Returns (paths, dists, statuses) for the packed batch."""
    from ..utils.profiling import trace_range
    B = q.shape[0]
    with trace_range("aligner.myers.score"):
        _, scores = banded.myers_bottom_row(q, qlen, t, tlen, backend,
                                            interpret)
        scores = np.asarray(scores)
    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)

    paths: list[list[int]] = [[] for _ in range(B)]
    statuses = np.full(B, int(StatusType.SUCCESS))
    # bucket by band radius = next pow2 >= s (s >= |n-m| always)
    radii = np.maximum(scores, 1)
    buckets: dict[int, list[int]] = {}
    hirsch: list[int] = []
    Lq, Lt = q.shape[1], t.shape[1]
    for b in range(B):
        if qlen[b] == 0 and tlen[b] == 0:
            continue                      # batch-padding rows: empty path
        r = 1 << int(radii[b] - 1).bit_length()
        r = max(r, 8)
        if (queries is not None and b < len(queries)
                and _infeasible(Lq, Lt, r, backend, interpret)):
            hirsch.append(b)
        else:
            buckets.setdefault(r, []).append(b)

    for r, idxs in sorted(buckets.items()):
        # chunk each bucket so per-dispatch tb bytes stay within budget
        chunk = _chunk(Lq, Lt, r, len(idxs), backend, interpret)
        for s0 in range(0, len(idxs), chunk):
            rows = banded.pow2_rows(idxs[s0: s0 + chunk])
            with trace_range("aligner.myers.banded"):
                _, tb = banded.banded_nw(q[rows], qlen[rows], t[rows],
                                         tlen[rows], r, backend, interpret)
            with trace_range("aligner.myers.decode"):
                sub_paths = banded.traceback_paths(tb, qlen[rows],
                                                   tlen[rows], r)
            for k, b in enumerate(idxs[s0: s0 + chunk]):
                paths[b] = sub_paths[k]

    if hirsch:
        from .hirschberg import hirschberg_align_batch
        with trace_range("aligner.myers.hirschberg"):
            h_paths, _, _ = hirschberg_align_batch(
                [queries[b] for b in hirsch], [targets[b] for b in hirsch],
                cfg, backend=backend, interpret=interpret)
        for k, b in enumerate(hirsch):
            paths[b] = h_paths[k]
    return paths, scores, statuses
