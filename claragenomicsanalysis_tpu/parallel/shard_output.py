"""Sharded multi-host OUTPUT path (SURVEY §5.8 "per-host files merged
deterministically").

The replicated path (Overlapper.compact_rows(mesh=...)) pins replicated
out-shardings so every host materializes ALL overlaps — right for
bit-identical small runs, wrong at pod scale, where each host holding the
global overlap set defeats the point of sharding the computation.  Here
each 'rep' shard's rows are compacted on its own device, written ONCE (by
the process owning the shard's primary replica) as a part file, and a
deterministic merge — parts in (pair, shard) ascending order, then one
stable canonical sort — reproduces `map_all_vs_all(mesh=...)`'s output
byte-for-byte (asserted by tests and the 2-process Gloo worker).

The reference has no analog: its multi-GPU output merge is a host-side
mutex'd PAF writer on ONE node (cudamapper/src/main.cpp [U]).
"""

import os
import re

import numpy as np

_PART_RE = re.compile(r"part_p(\d+)_r(\d+)\.npy$")


def map_all_vs_all_sharded(parser, cfg, out_dir: str, mesh,
                           max_anchors: int | None = None) -> tuple:
    """All-vs-all mapping with SHARDED output: this process writes
    `part_p{pair}_r{shard}.npy` (an (8, n) canonical overlap-rows array)
    for exactly the rep shards it owns; no host ever materializes the
    global overlap set.  Returns (paths written locally, n_pairs)."""
    from ..core.bufferplan import anchor_capacity
    from ..models.mapper import (IndexCache, Overlapper,
                                 _pack2_ok_global)
    from .shard import sharded_match_chain
    if mesh.shape.get("rep", 1) < 2:
        raise ValueError("sharded output needs a mesh with a rep axis >= 2")
    os.makedirs(out_dir, exist_ok=True)
    if max_anchors is None:
        max_anchors = anchor_capacity()
    chunks = parser.get_chunks(cfg.index_size_mb * 1_000_000)
    cache = IndexCache()
    written: list[str] = []
    pairs = [(q, t) for q in chunks for t in chunks]
    for pi, ((qf, ql), (tf, tl)) in enumerate(pairs):
        qidx = cache.get_or_create(parser, qf, ql, cfg)
        tidx = cache.get_or_create(parser, tf, tl, cfg)
        out, _ = sharded_match_chain(
            qidx._arrays, tidx._arrays, cfg, mesh, cap=max_anchors,
            pack2=_pack2_ok_global(qidx, tidx),
            n_query_reads=len(qidx.read_lengths),
            first_read=qidx.first_read_id)
        for r, rows in Overlapper.compact_rows_local(out, mesh).items():
            path = os.path.join(out_dir, f"part_p{pi:05d}_r{r:03d}.npy")
            np.save(path, rows)
            written.append(path)
    return written, len(pairs)


def merge_sharded_rows(out_dir: str) -> np.ndarray:
    """Deterministic merge of part files: (pair, shard) ascending order,
    then one stable canonical sort — equal to map_all_vs_all's row order
    exactly (equal keys can only repeat across pairs, never across shards,
    because each shard owns a disjoint query-id range)."""
    from ..models.mapper import _canonical_order
    parts = []
    for name in os.listdir(out_dir):
        m = _PART_RE.match(name)
        if m:
            parts.append((int(m.group(1)), int(m.group(2)), name))
    parts.sort()
    arrs = [np.load(os.path.join(out_dir, name)) for _, _, name in parts]
    rows = (np.concatenate(arrs, axis=1) if arrs
            else np.zeros((8, 0), np.int32))
    return rows[:, _canonical_order(rows)]


def write_merged_paf(parser, out_dir: str, out_path: str) -> int:
    """Merge part files into one PAF (canonical order).  Returns row count.
    Run after every process finished writing (e.g. behind a
    jax.experimental.multihost_utils.sync_global_devices barrier)."""
    from ..models.mapper import Overlapper, overlaps_to_paf
    rows = merge_sharded_rows(out_dir)
    overlaps = Overlapper.rows_to_overlaps(rows)
    with open(out_path, "w") as f:
        for line in overlaps_to_paf(overlaps, parser):
            f.write(line + "\n")
    return len(overlaps)
