"""Read-correction driver — the pod-scale composition (BASELINE config #5).

All-vs-all map -> per-overlap base-exact re-alignment -> per-read pileup
windows -> batched POA consensus -> corrected reads (Racon-style polishing;
the reference ships the POA compute core this drives — reference:
cudapoa/include/claragenomics/cudapoa/batch.hpp [U] — but no correction app;
SURVEY.md §7 step 7 names this composition as the north-star deliverable).

Device behavior:
- every compute stage is the batched XLA/Pallas program of its module
  (mapper, aligner, POA); the driver is pure composition;
- `mesh` shards matching over the 'rep' axis and POA windows over the
  'data' axis; output is bit-identical for any mesh size (asserted by
  tests on the 8-fake-device CPU mesh);
- `work_dir` makes the run resumable: the mapping loop checkpoints per
  (query-batch x target-batch) pair (parallel/manifest.py) and correction
  checkpoints per read part; a killed run resumes bit-identically.
"""

import json
import os
from dataclasses import dataclass

import numpy as np

from ..core.config import BatchSize, CorrectConfig
from ..core.status import StatusType
from ..core.types import Overlap
from ..io.fasta import FastaParser
from ..models.aligner import create_aligner
from ..models.mapper import map_all_vs_all
from ..models.poa import create_batch
from ..utils.genomeutils import reverse_complement
from ..utils.profiling import trace_range


@dataclass
class CorrectResult:
    names: list[str]
    seqs: list[str]
    n_windows: int          # total backbone windows
    n_polished: int         # windows that went through POA successfully
    n_window_failed: int    # POA-attempted windows that kept the backbone


def _matched_pairs(path: list[int], o: Overlap):
    """(positions in query read, forward-strand positions in target read) of
    every matched/mismatched column of the overlap's alignment.  Query
    positions are strictly increasing; '-' overlaps give decreasing target
    positions (PAF keeps target coordinates on the forward strand)."""
    codes = np.asarray(path, np.int8)
    if codes.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    cq = codes != 3   # match/mismatch/insertion consume query
    ct = codes != 2   # match/mismatch/deletion consume target
    qoff = np.cumsum(cq) - cq
    toff = np.cumsum(ct) - ct
    m = codes <= 1
    rq = o.query_start_position_in_read + qoff[m]
    if o.relative_strand == "+":
        rt = o.target_start_position_in_read + toff[m]
    else:
        rt = o.target_end_position_in_read - 1 - toff[m]
    return rq.astype(np.int64), rt.astype(np.int64)


def _align_overlaps(overlaps: list[Overlap], parser: FastaParser,
                    cfg: CorrectConfig, batch_size: int = 2048):
    """Base-exact alignment of each overlap's spans (same batching discipline
    as models/pipeline.py — large chunks, because the myers driver already
    bounds per-dispatch memory).  Returns one path (AlignmentState codes) per overlap;
    unalignable overlaps get an empty path.

    Spans are grouped by their OWN pow2 length bucket, not the part's
    global max: the Myers scoring pass is O(Lq*Lt), so one 5 kb overlap
    in a part must not pad every 512 bp span to 8192^2 cells (167x
    waste).  O(log L) buckets keep the executable count bounded.  Each
    span's path is deterministic and optimal for its bucket, but the
    driver's Myers-vs-Hirschberg routing keys on the PADDED shape
    (tb_bytes_per_problem), so a span near the routing boundary can take
    the other (equally optimal, differently tie-broken) traceback path
    than it would under the old single-bucket packing."""
    spans = []
    for o in overlaps:
        q = parser.get_sequence_by_id(o.query_read_id).seq[
            o.query_start_position_in_read:o.query_end_position_in_read]
        t = parser.get_sequence_by_id(o.target_read_id).seq[
            o.target_start_position_in_read:o.target_end_position_in_read]
        if o.relative_strand == "-":
            t = reverse_complement(t)
        spans.append((q, t))

    buckets: dict[int, list[int]] = {}
    for i, (q, t) in enumerate(spans):
        L = max(64, 1 << (max(len(q), len(t), 1) - 1).bit_length())
        buckets.setdefault(L, []).append(i)

    paths: list[list[int]] = [[] for _ in spans]
    for L, idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), batch_size):
            sel = idxs[start:start + batch_size]
            # banded-escalate skips the O(Lq*Lt) Myers scoring pass and
            # yields the identical canonical dense paths for spans that resolve
            # in-band — see align/myers_aligner.banded_escalate_align_batch
            aligner = create_aligner(
                L, L, len(sel),
                band_radius=min(cfg.aligner_band_radius, L),
                algorithm="banded-escalate")
            for i in sel:
                aligner.add_alignment(*spans[i])
            for i, a in zip(sel, aligner.get_alignments()):
                paths[i] = a.path if a.status == StatusType.SUCCESS else []
    return paths


def _window_supports(read_seq: str, overlaps: list[Overlap],
                     paths: list[list[int]], parser: FastaParser,
                     cfg: CorrectConfig) -> list[list[str]]:
    """Per-window support segments for one read.  Window wi covers backbone
    bases [wi*W, (wi+1)*W); a support is the other read's substring whose
    aligned columns land in the window, oriented along the backbone.

    Canonical rules (OURS, documented): supports are taken in canonical
    overlap order and capped at cfg.max_support; a support needs >=
    cfg.min_matched_bases matched columns in the window and its segment may
    not exceed 2 * window_length (a longer segment means a pathological
    alignment)."""
    W = cfg.window_length
    n_win = (len(read_seq) + W - 1) // W
    supports: list[list[str]] = [[] for _ in range(n_win)]
    for o, path in zip(overlaps, paths):
        if not path:
            continue
        rq, rt = _matched_pairs(path, o)
        if rq.size == 0:
            continue
        other = parser.get_sequence_by_id(o.target_read_id).seq
        w_first = int(rq[0]) // W
        w_last = int(rq[-1]) // W
        # rq is sorted increasing: searchsorted slices each window's columns
        bounds = np.searchsorted(
            rq, np.arange(w_first, w_last + 2, dtype=np.int64) * W)
        for wi in range(w_first, min(w_last + 1, n_win)):
            if len(supports[wi]) >= cfg.max_support:
                continue
            s, e = bounds[wi - w_first], bounds[wi - w_first + 1]
            if e - s < cfg.min_matched_bases:
                continue
            seg_t = rt[s:e]
            lo = int(seg_t.min())
            hi = int(seg_t.max()) + 1
            if hi - lo > 2 * W:
                continue
            seg = other[lo:hi]
            if o.relative_strand == "-":
                seg = reverse_complement(seg)
            supports[wi].append(seg)
    return supports


#: device-memory budget for one POA dispatch of the polishing stage;
#: core.bufferplan turns this into a windows-per-dispatch count
POA_MEM_BUDGET = 1 << 30


def _polish_batch_size(cfg: CorrectConfig, depth: int) -> BatchSize:
    """BatchSize for a polish dispatch of pileups up to `depth` sequences
    (backbone included).

    - deep noisy pileups accumulate many deletion skip-edges per node; the
      default pred cap of 4 (CUDAPOA_MAX_NODE_EDGES analog) overflows at
      ~10+ supports, so the caps scale with the pileup depth;
    - max_nodes: backbone W plus error branches — 3*W is ample for <=30%
      divergence and keeps the padded window plan (and its POA cost) at
      half the BatchSize default of 3*max_sequence_size = 6*W."""
    W = cfg.window_length
    return BatchSize(max_sequence_size=2 * W,
                     max_nodes_per_window=3 * W,
                     max_sequences_per_poa=depth,
                     max_pred_per_node=max(4, depth),
                     max_aligned_per_node=max(4, depth // 2))


def _polish_windows(jobs: list[list[str]], cfg: CorrectConfig, mesh,
                    windows_per_dispatch: int | None) -> tuple[list[str], int]:
    """POA consensus for each job (= [backbone, support...]).  Returns the
    consensus strings (backbone kept where POA fails) and the failure
    count.  windows_per_dispatch=None sizes dispatches from the
    core.bufferplan capacity arithmetic (the BatchBlock analog).

    Jobs are bucketed by pow2 pileup depth: the POA scan runs
    max_sequences_per_poa - 1 lockstep add steps whether or not a window's
    sequences are exhausted, and the kernels' pred loops scale with
    max_pred_per_node — so a 4-deep window dispatched at the max_support
    shape costs ~4x its bucketed cost in scan length alone.  O(log S)
    buckets bound the executable count; each bucket's caps follow the same
    depth-scaling rule the single global shape used, applied to the
    bucket's own depth."""
    from ..core.bufferplan import plan_poa_batch
    S_cap = cfg.max_support + 1
    buckets: dict[int, list[int]] = {}
    for i, seqs in enumerate(jobs):
        d = min(max(4, 1 << (len(seqs) - 1).bit_length()), S_cap)
        buckets.setdefault(d, []).append(i)

    out: list[str | None] = [None] * len(jobs)
    n_failed = 0

    def drain(sel, chunk, batch):
        nonlocal n_failed
        cons, _, stats = batch.get_consensus()   # materializes (blocks)
        for i, seqs, c, st in zip(sel, chunk, cons, stats):
            if st == StatusType.SUCCESS and c:
                out[i] = c
            else:
                out[i] = seqs[0]  # graceful degradation: keep backbone
                n_failed += 1

    # Pipelined dispatches (the reference's multibatch/stream-overlap axis,
    # cudapoa/benchmarks/multibatch [U]): generate_poa only packs +
    # dispatches, so chunk i+1 is packed and in flight while chunk i
    # computes; drain (the blocking device->host read) runs one behind —
    # including across bucket boundaries.
    pending = None
    for depth, idxs in sorted(buckets.items()):
        bs = _polish_batch_size(cfg, depth)
        wpd = (windows_per_dispatch if windows_per_dispatch is not None
               else plan_poa_batch(bs, POA_MEM_BUDGET).problems_per_batch)
        for start in range(0, len(idxs), wpd):
            sel = idxs[start:start + wpd]
            chunk = [jobs[i] for i in sel]
            batch = create_batch(batch_size=bs, max_poas=len(chunk),
                                 mesh=mesh)
            for seqs in chunk:
                batch.add_poa_group(seqs)
            batch.generate_poa()                 # async dispatch
            if pending is not None:
                drain(*pending)
            pending = (sel, chunk, batch)
    if pending is not None:
        drain(*pending)
    # every job index must land in exactly one depth bucket; a future
    # bucketing change must not silently join None into a corrected read
    assert all(s is not None for s in out), "unpolished job slot"
    return out, n_failed


def _correct_part(read_ids: list[int], by_query: dict[int, list[Overlap]],
                  parser: FastaParser, cfg: CorrectConfig, mesh,
                  windows_per_dispatch: int | None):
    """Correct one contiguous part of reads.  Returns (seqs, n_windows,
    n_polished, n_failed)."""
    # 1) per-overlap exact alignments for this part's reads
    part_overlaps: list[Overlap] = []
    for rid in read_ids:
        part_overlaps.extend(by_query.get(rid, ()))
    with trace_range("correct.align"):
        paths = _align_overlaps(part_overlaps, parser, cfg)
    path_of = dict(zip(map(id, part_overlaps), paths))

    # 2) window supports per read; collect POA jobs
    jobs: list[list[str]] = []
    slots: list[tuple[int, int]] = []   # (read slot, window idx) per job
    pieces: list[list[str]] = []
    n_windows = 0
    with trace_range("correct.windows"):
        for slot, rid in enumerate(read_ids):
            seq = parser.get_sequence_by_id(rid).seq
            ovl = by_query.get(rid, [])
            sup = _window_supports(seq, ovl, [path_of[id(o)] for o in ovl],
                                   parser, cfg)
            Wl = cfg.window_length
            piece = []
            for wi in range((len(seq) + Wl - 1) // Wl or 0):
                backbone = seq[wi * Wl: (wi + 1) * Wl]
                n_windows += 1
                if len(sup[wi]) >= cfg.min_supports_for_poa and backbone:
                    slots.append((slot, wi))
                    jobs.append([backbone] + sup[wi])
                    piece.append(None)      # filled from POA below
                else:
                    piece.append(backbone)
            pieces.append(piece)

    # 3) batched POA polish
    with trace_range("correct.poa"):
        cons, n_failed = _polish_windows(jobs, cfg, mesh,
                                         windows_per_dispatch)
    for (slot, wi), c in zip(slots, cons):
        pieces[slot][wi] = c
    seqs = ["".join(p) for p in pieces]
    return seqs, n_windows, len(jobs) - n_failed, n_failed


def correct_reads(parser: FastaParser, cfg: CorrectConfig, mesh=None,
                  work_dir: str | None = None, part_size: int = 64,
                  windows_per_dispatch: int | None = None,
                  fail_after_parts: int | None = None) -> CorrectResult:
    """Correct every read of `parser` against all others.

    mesh: optional Mesh — rep-sharded matching + data-sharded POA.
    work_dir: enables checkpoint/resume (map pairs + read parts).
    fail_after_parts: fault-injection hook for resume tests."""
    n = parser.get_num_sequences()
    names = [parser.get_sequence_by_id(i).name for i in range(n)]
    from ..parallel.mesh import axis_meshes
    mesh_data, mesh_rep = axis_meshes(mesh)

    with trace_range("correct.map"):
        if work_dir:
            from ..parallel.manifest import map_all_vs_all_resumable
            overlaps, _, _ = map_all_vs_all_resumable(
                parser, cfg.mapper, os.path.join(work_dir, "map"),
                mesh=mesh_rep)
        else:
            overlaps = map_all_vs_all(parser, cfg.mapper,
                                      mesh=mesh_rep).overlaps

    # supports come from overlaps where the corrected read is the QUERY
    # (all-vs-all emits both orders of each pair, so every partner appears)
    by_query: dict[int, list[Overlap]] = {}
    for o in overlaps:
        if max(o.query_end_position_in_read - o.query_start_position_in_read,
               o.target_end_position_in_read - o.target_start_position_in_read
               ) > cfg.max_alignment_length:
            continue
        by_query.setdefault(o.query_read_id, []).append(o)

    manifest_path = (os.path.join(work_dir, "correct_manifest.json")
                     if work_dir else None)
    done: dict[str, bool] = {}
    if manifest_path and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = json.load(f)

    parts = [list(range(s, min(s + part_size, n)))
             for s in range(0, n, part_size)]
    seqs: list[str | None] = [None] * n
    totals = [0, 0, 0]
    computed = 0
    for pi, read_ids in enumerate(parts):
        part_file = (os.path.join(work_dir, f"corrected_part_{pi}.json")
                     if work_dir else None)
        if part_file and done.get(str(pi)):
            with open(part_file) as f:
                part = json.load(f)
            part_seqs = part["seqs"]
            stats = part["stats"]
        else:
            part_seqs, *stats = _correct_part(
                read_ids, by_query, parser, cfg, mesh_data,
                windows_per_dispatch)
            if part_file:
                with open(part_file, "w") as f:
                    json.dump({"seqs": part_seqs, "stats": stats}, f)
                done[str(pi)] = True
                with open(manifest_path, "w") as f:
                    json.dump(done, f)
            computed += 1
            if fail_after_parts is not None and computed >= fail_after_parts:
                raise RuntimeError("injected failure for resume test")
        for rid, s in zip(read_ids, part_seqs):
            seqs[rid] = s
        for i in range(3):
            totals[i] += stats[i]

    return CorrectResult(names, seqs, *totals)


def write_fasta(result: CorrectResult, path: str) -> None:
    with open(path, "w") as f:
        for name, seq in zip(result.names, result.seqs):
            f.write(f">{name}\n{seq}\n")
