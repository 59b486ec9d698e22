"""Checkpoint/resume for the all-vs-all loop (SURVEY.md §5.4 — the reference
has no fault tolerance; this is new capability).

The (query-batch x target-batch) loop writes one PAF part file per completed
pair plus a manifest entry; a killed run resumes by skipping completed pairs;
the final merge is in canonical Overlap.key() order, so a resumed run's
output is bit-identical to an uninterrupted one (asserted by tests).
"""

import json
import os

from ..core.bufferplan import anchor_capacity
from ..core.config import MapperConfig
from ..core.types import Overlap
from ..io.paf import format_paf_row
from ..models.mapper import IndexCache, Matcher, Overlapper


def _pair_name(qf, ql, tf, tl) -> str:
    return f"part_q{qf}-{ql}_t{tf}-{tl}"


def map_all_vs_all_resumable(parser, cfg: MapperConfig, work_dir: str,
                             max_anchors: int | None = None,
                             fail_after_pairs: int | None = None,
                             mesh=None):
    """Resumable all-vs-all mapping.  `fail_after_pairs` injects a crash after
    N newly-computed pairs (fault-injection hook for tests).  `mesh` shards
    matching over its 'rep' axis (results identical for any mesh size).

    Returns (overlaps sorted canonically, n_pairs_computed, n_pairs_skipped).
    """
    os.makedirs(work_dir, exist_ok=True)
    if max_anchors is None:
        max_anchors = anchor_capacity()
    manifest_path = os.path.join(work_dir, "manifest.json")
    done: dict[str, bool] = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = json.load(f)

    chunks = parser.get_chunks(cfg.index_size_mb * 1_000_000)
    cache = IndexCache()
    computed = skipped = 0
    for (qf, ql) in chunks:
        for (tf, tl) in chunks:
            name = _pair_name(qf, ql, tf, tl)
            if done.get(name):
                skipped += 1
                continue
            qidx = cache.get_or_create(parser, qf, ql, cfg)
            tidx = cache.get_or_create(parser, tf, tl, cfg)
            from ..models.mapper import (_mesh_overlap_rows, _pack2_ok,
                                         _pack2_ok_global)
            if mesh is not None and mesh.shape.get("rep", 1) > 1:
                rows, _ = _mesh_overlap_rows(qidx, tidx, cfg, mesh,
                                             max_anchors,
                                             _pack2_ok_global(qidx, tidx))
                overlaps = Overlapper.rows_to_overlaps(rows)
            else:
                matcher = Matcher.create_matcher(qidx, tidx, cfg,
                                                 cap=max_anchors)
                overlaps = Overlapper.get_overlaps(
                    matcher.anchors(), cfg, pack2=_pack2_ok(qidx, tidx),
                    q_base=qidx.first_read_id, t_base=tidx.first_read_id)
            with open(os.path.join(work_dir, name + ".jsonl"), "w") as f:
                for o in overlaps:
                    f.write(json.dumps(o.__dict__) + "\n")
            done[name] = True
            with open(manifest_path, "w") as f:
                json.dump(done, f)
            computed += 1
            if fail_after_pairs is not None and computed >= fail_after_pairs:
                raise RuntimeError("injected failure for resume test")

    overlaps: list[Overlap] = []
    for (qf, ql) in chunks:
        for (tf, tl) in chunks:
            path = os.path.join(work_dir,
                                _pair_name(qf, ql, tf, tl) + ".jsonl")
            with open(path) as f:
                for line in f:
                    overlaps.append(Overlap(**json.loads(line)))
    overlaps.sort(key=lambda o: o.key())
    return overlaps, computed, skipped


def write_merged_paf(overlaps, parser, out_path: str) -> None:
    with open(out_path, "w") as f:
        for o in overlaps:
            q = parser.get_sequence_by_id(o.query_read_id)
            t = parser.get_sequence_by_id(o.target_read_id)
            f.write(format_paf_row(o, q.name, len(q.seq), t.name,
                                   len(t.seq)) + "\n")
