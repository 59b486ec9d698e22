"""Hirschberg–Myers divide-and-conquer aligner for long pairs.

Linear-memory global alignment: Myers bottom-row scores locate the optimal
crossing column of the middle query row; recursion solves the two halves
(reference: cudaaligner/src/hirschberg_myers_gpu.cu [U], which runs a
device-side work stack).  This design is a *level-batched* host driver:
at each recursion level, ALL open fragments across the whole batch are padded
into ONE forward + reverse Myers call (O(log L) levels), and all base-case
fragments are solved by the canonical banded-NW
kernel in power-of-two buckets.

The produced path is optimal (cost == edit distance, asserted in tests) and
deterministic (split ties -> smallest column), but unlike the `myers`
algorithm it is not guaranteed to equal the dense canonical tie-break path —
same caveat as the reference's Hirschberg vs its own full-matrix Myers.
"""

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import AlignerConfig
from ..core.status import StatusType
from ..ops import banded
from ..ops.banded import myers_bottom_row
from ..utils.genomeutils import encode

BASE_Q = 32  # fragments with query side <= BASE_Q solve directly


@dataclass
class _Frag:
    pair: int
    qlo: int
    qhi: int
    tlo: int
    thi: int


def _p2(x: int, lo: int) -> int:
    """pow2 bucket >= max(x, lo) — bounds the number of XLA executables to
    O(log^2) over all levels and calls (repo-wide shape discipline)."""
    return max(lo, 1 << (max(x, 1) - 1).bit_length())


def _pad_batch(seqs: list[np.ndarray], L: int, B: int | None = None
               ) -> np.ndarray:
    out = np.full((B or len(seqs), L), -1, dtype=np.int8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


def hirschberg_align_batch(queries: list[str], targets: list[str],
                           cfg: AlignerConfig, mesh=None,
                           sp_min_len: int | None = None,
                           backend: str = "auto", interpret: bool = False):
    """Returns (paths, dists, statuses) matching models.aligner's contract.

    mesh + sp_min_len: levels whose padded sides reach sp_min_len compute
    their forward/reverse bottom rows on the 'sp' ring-wavefront kernel
    (parallel/ring_nw.py) instead of single-device Myers — the
    sequence-parallel path for fragments too long for one device.  Split
    selection is the same argmin over the same unit-cost rows, so routing
    does not change results.

    sp_min_len=None with an sp-capable mesh AUTO-derives the threshold
    from the device's memory (core.bufferplan.myers_max_query_len): levels
    one device cannot hold route to the ring with no manual tuning."""
    if (sp_min_len is None and mesh is not None
            and mesh.shape.get("sp", 1) > 1):
        from ..core.bufferplan import myers_max_query_len
        sp_min_len = myers_max_query_len()
        from ..utils.logging import get_logger
        get_logger().info("hirschberg: auto sp threshold %d bases "
                          "(device-memory-derived); longer levels use the "
                          "ring-wavefront 'sp' axis", sp_min_len)
    B = len(queries)
    qcodes = [encode(s) for s in queries]
    tcodes = [encode(s) for s in targets]
    pieces: dict[int, list[tuple[int, int, list[int]]]] = {b: [] for b in range(B)}

    frags = [_Frag(b, 0, len(qcodes[b]), 0, len(tcodes[b])) for b in range(B)]
    while frags:
        base = [f for f in frags if f.qhi - f.qlo <= BASE_Q]
        split = [f for f in frags if f.qhi - f.qlo > BASE_Q]
        if base:
            _solve_base(base, qcodes, tcodes, pieces, backend, interpret)
        frags = (_split_level(split, qcodes, tcodes, mesh, sp_min_len,
                              backend, interpret) if split else [])

    paths = []
    dists = np.zeros(B, dtype=np.int64)
    statuses = np.full(B, int(StatusType.SUCCESS))
    for b in range(B):
        path: list[int] = []
        for _, _, p in sorted(pieces[b], key=lambda x: (x[0], x[1])):
            path.extend(p)
        paths.append(path)
        dists[b] = sum(1 for s in path if s != 0)
    return paths, dists, statuses


def _solve_base(base: list[_Frag], qcodes, tcodes, pieces,
                backend: str = "auto", interpret: bool = False) -> None:
    """Solve small fragments with the configured banded-NW kernel (the
    Aligner's backend string, threaded down so every level uses the same
    kernel choice), bucketed by power-of-two band radius (r = max side
    covers any path)."""
    buckets: dict[int, list[_Frag]] = {}
    for f in base:
        side = max(f.qhi - f.qlo, f.thi - f.tlo, 1)
        r = max(8, 1 << (side - 1).bit_length())
        buckets.setdefault(r, []).append(f)
    for r, fs in sorted(buckets.items()):
        qs = [qcodes[f.pair][f.qlo:f.qhi] for f in fs]
        ts = [tcodes[f.pair][f.tlo:f.thi] for f in fs]
        Lq = _p2(max((len(x) for x in qs), default=1), 8)
        Lt = _p2(max((len(x) for x in ts), default=1), 8)
        Bp = _p2(len(fs), 8)
        q = _pad_batch(qs, Lq, Bp)
        t = _pad_batch(ts, Lt, Bp)
        qlen = np.zeros(Bp, np.int32)
        tlen = np.zeros(Bp, np.int32)
        qlen[: len(fs)] = [len(x) for x in qs]
        tlen[: len(fs)] = [len(x) for x in ts]
        _, tb = banded.banded_nw(q, qlen, t, tlen, r, backend, interpret)
        sub = banded.traceback_paths(tb, qlen, tlen, r)
        for f, p in zip(fs, sub):
            pieces[f.pair].append((f.qlo, f.tlo, p))


def _split_level(split: list[_Frag], qcodes, tcodes, mesh=None,
                 sp_min_len: int | None = None, backend: str = "auto",
                 interpret: bool = False) -> list[_Frag]:
    """One D&C level: forward + reverse bottom rows for every fragment in
    one batched call each; emit the two child fragments per input."""
    mids = [(f.qlo + f.qhi) // 2 for f in split]
    fwd_q = [qcodes[f.pair][f.qlo:m] for f, m in zip(split, mids)]
    rev_q = [qcodes[f.pair][m:f.qhi][::-1] for f, m in zip(split, mids)]
    fwd_t = [tcodes[f.pair][f.tlo:f.thi] for f in split]
    rev_t = [tcodes[f.pair][f.tlo:f.thi][::-1] for f in split]

    Lq = _p2(max(len(x) for x in fwd_q + rev_q), 8)
    Lt = _p2(max(len(x) for x in fwd_t), 8)
    n = len(split)
    half = _p2(n, 4)                      # fwd half at [0, half), rev after
    Bp = 2 * half
    q = np.concatenate([_pad_batch(fwd_q, Lq, half),
                        _pad_batch(rev_q, Lq, half)])
    t = np.concatenate([_pad_batch(fwd_t, Lt, half),
                        _pad_batch(rev_t, Lt, half)])
    qlen = np.zeros(Bp, np.int32)
    tlen = np.zeros(Bp, np.int32)
    qlen[:n] = [len(x) for x in fwd_q]
    qlen[half: half + n] = [len(x) for x in rev_q]
    tlen[:n] = [len(x) for x in fwd_t]
    tlen[half: half + n] = [len(x) for x in rev_t]
    use_sp = (mesh is not None and sp_min_len is not None
              and mesh.shape.get("sp", 1) > 1
              and max(Lq, Lt) >= sp_min_len)
    if use_sp:
        # sequence-parallel rows: target axis sharded over the 'sp' ring
        from ..parallel.ring_nw import ring_wavefront_nw_rows
        rows = jnp.asarray(
            ring_wavefront_nw_rows(q, qlen, t, tlen, mesh)[:, :Lt + 1])
    else:
        rows = myers_bottom_row(q, qlen, t, tlen, backend, interpret)[0]
    # split columns computed ON DEVICE: only (n,) ints leave the device,
    # instead of the full (Bp, Lt+1) forward+reverse row matrices
    jstars = np.asarray(_split_points(rows, jnp.asarray(tlen), half))

    out: list[_Frag] = []
    for i, (f, m) in enumerate(zip(split, mids)):
        jstar = int(jstars[i])
        out.append(_Frag(f.pair, f.qlo, m, f.tlo, f.tlo + jstar))
        out.append(_Frag(f.pair, m, f.qhi, f.tlo + jstar, f.thi))
    return out


@functools.partial(jax.jit, static_argnames=("half",))
def _split_points(rows, tlen, half: int):
    """jstar[i] = argmin_j (fwd_rows[i, j] + rev_rows[i, mlen-j]) for
    j in [0, mlen], ties -> smallest j (mlen = tlen[i])."""
    fr = rows[:half]                      # (half, Lt+1)
    rr = rows[half: 2 * half]
    mlen = tlen[:half][:, None]           # == tlen[half:2*half] by constr.
    jj = jnp.arange(fr.shape[1], dtype=jnp.int32)[None, :]
    rrv = jnp.take_along_axis(rr, jnp.clip(mlen - jj, 0, fr.shape[1] - 1),
                              axis=1)
    total = jnp.where(jj <= mlen, fr + rrv, jnp.int32(2**30))
    return jnp.argmin(total, axis=1).astype(jnp.int32)
