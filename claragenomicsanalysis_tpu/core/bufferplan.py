"""Batch-capacity planning — the spiritual port of the reference's slab
planners (reference: cudaaligner/src/batched_device_matrices.cuh [U],
cudapoa/src/allocate_block.cpp [U]).

XLA owns actual device memory, so nothing here allocates; what survives is the
*planning* arithmetic: given a device-memory budget, how many problems fit in
one statically-shaped batch.  Shape-static padding is the XLA analog of slab
carving.
"""

import functools
import os
from dataclasses import dataclass

from .config import AlignerConfig, BatchSize


@dataclass(frozen=True)
class BufferPlan:
    problems_per_batch: int
    bytes_per_problem: int
    total_bytes: int


def plan_aligner_batch(cfg: AlignerConfig, mem_budget_bytes: int) -> BufferPlan:
    """Bytes per alignment: packed sequences + band traceback + score band.

    Traceback stores one uint8 move code per (anti-diagonal, band cell):
    (Lq + Lt + 1) * band_width bytes; the rolling score state is 3 band rows
    of int32.
    """
    n_diags = cfg.padded_query_length + cfg.padded_target_length + 1
    seq_bytes = cfg.padded_query_length + cfg.padded_target_length  # int8 codes
    tb_bytes = n_diags * cfg.band_width
    score_bytes = 3 * cfg.band_width * 4
    per = seq_bytes + tb_bytes + score_bytes
    n = max(1, mem_budget_bytes // per)
    n = min(n, cfg.max_alignments)
    return BufferPlan(n, per, n * per)


@functools.cache
def device_memory_bytes() -> int:
    """Memory of the first local device: the allocator's limit on a GPU,
    physical host memory on the CPU backend (which reports none)."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def dispatch_bytes(memory_bytes: int | None = None) -> int:
    """Device bytes one banded-NW dispatch may hold in tracebacks: a 64th
    of the device's memory, so the score, sequence and decode buffers of
    the dispatch in flight and the one being downloaded fit beside it."""
    if memory_bytes is None:
        memory_bytes = device_memory_bytes()
    return memory_bytes // 64


#: device bytes one anchor may cost at the peak of a mapper pair step: the
#: expansion's six fields and its fill temporaries, the chain sort's keys
#: and payload copies, and the compaction, with room to spare (an H100 peaked
#: at 5.53 GB, about 150 B per anchor, on a 2000 x 10 kb all-vs-all pair of
#: about 37 M anchors)
ANCHOR_BYTES = 256


def anchor_capacity(memory_bytes: int | None = None) -> int:
    """Most anchors one (query, target) index pair may expand to before it
    reports EXCEEDED_MAX_ANCHORS: the largest power of two whose anchors
    fit the device's memory at ANCHOR_BYTES each, at most 2**30 (the
    int32 offsets of the expansion)."""
    if memory_bytes is None:
        memory_bytes = device_memory_bytes()
    n = max(memory_bytes // ANCHOR_BYTES, 1 << 20)
    return min(1 << (n.bit_length() - 1), 1 << 30)


#: device bytes one Hirschberg level spends per padded query base of a
#: pair: int32 forward + reverse bottom rows over a target as long as the
#: query (8 B), the strip carry (1 B) and Peq masks (0.5 B), rounded up
MYERS_LEVEL_BYTES_PER_BASE = 16


def myers_max_query_len(memory_bytes: int | None = None) -> int:
    """Longest padded query whose Myers level one device holds in a quarter
    of its memory.  Beyond this a level should route to the 'sp'
    ring-wavefront axis (align/hirschberg.py auto-routing, SURVEY §5.7)."""
    if memory_bytes is None:
        memory_bytes = device_memory_bytes()
    return max(32, memory_bytes // 4 // MYERS_LEVEL_BYTES_PER_BASE
               // 32 * 32)


def plan_poa_batch(bs: BatchSize, mem_budget_bytes: int) -> BufferPlan:
    """Bytes per POA window: node SoA + score matrix + per-read paths.

    Node SoA: base (1B) + coverage (4B) + pred/succ index+weight
    (max_pred * 2 * 8B) + aligned links (max_aligned * 4B), per node.
    Score matrix: padded_nodes x padded_seq int16 (kept for traceback).
    """
    node_bytes = 1 + 4 + bs.max_pred_per_node * 16 + bs.max_aligned_per_node * 4
    soa = bs.padded_nodes * node_bytes
    scores = bs.padded_nodes * bs.padded_seq * 2
    paths = bs.max_sequences_per_poa * bs.padded_seq * 4
    per = soa + scores + paths
    n = max(1, mem_budget_bytes // per)
    return BufferPlan(n, per, n * per)
