"""Index build, anchor matching, and triggered chaining on device.

XLA redesign of (reference: cudamapper/src/index_gpu.cuh [thrust radix
sort + RLE], matcher_gpu.cu [lower_bound + scan + expand kernels],
overlapper_triggered.cu [cub sort + chain scan] [U]):

- index build: ONE lax.sort over (rep, read_id, pos) key operands (INVALID
  reps sort to the back); per-element occurrence counts come from two
  searchsorteds on the sorted rep array (no segment capacity needed);
  frequency filtering marks reps INVALID and stably re-sorts.
- matching: searchsorted(target_reps, query_reps) left/right gives each query
  element its target range; the anchor expansion uses the classic
  exclusive-scan + searchsorted-over-cumsum trick into a static capacity
  (cap + count + overflow flag — the XLA answer to dynamic output sizes).
- chaining: one fused lexicographic sort (validity, q_id, t_id, strand,
  q_pos, strand-adjusted t_pos), chain-break flags, and run aggregation via
  cummax of chain-start indices — overlap records are emitted at chain ends.

Everything static-shape; dynamic sizes are (count, overflow) pairs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sketch import INVALID

I32MAX = jnp.int32(2**31 - 1)


def _sort_pairs(k1, k2):
    """Unstable ascending sort of distinct uint32 (k1, k2) pairs — the
    shared shape of the packed index sorts and the pack2 chain sort.

    XLA's fused multi-operand sort is used as is."""
    return jax.lax.sort((k1, k2), num_keys=2, is_stable=False)


@functools.partial(jax.jit, static_argnames=("filter_thr_num",
                                             "filter_thr_den",
                                             "with_packed"))
def build_index(rep, dirs, is_min, first_read_id: jnp.ndarray,
                filter_thr_num: int = 1, filter_thr_den: int = 1,
                with_packed: bool = False):
    """Flatten + sort sketch elements.  Returns dict of (C,) arrays sorted by
    (rep, read_id, pos) with INVALID-rep padding, plus n_elems.

    filter_thr_num/den encode filtering_parameter as a rational so the jit
    key stays hashable; reps with count > (num/den) * n_elems are dropped
    (den == num == 1 disables filtering).

    with_packed (callers set it when the chunk has < 2^15 reads and reads
    < 2^16 bases — the common case): adds a uint32 "packed" array
    (dir<<31 | local_read<<16 | pos) plus "first_read", so the matcher's
    random target-side lookups become ONE gather instead of three.
    """
    B, Lk = rep.shape
    C = B * Lk
    flat_rep = jnp.where(is_min, rep, INVALID).reshape(-1)
    flat_dir = dirs.reshape(-1)
    n_elems = jnp.sum(is_min).astype(jnp.int32)

    if with_packed:
        # the whole (read, pos, dir) payload fits ONE uint32 word under the
        # with_packed precondition (local ids < 2^15, pos < 2^16), so the
        # index sort runs 2 operands instead of 4.  (local, pos) is unique
        # per element, so folding dir into the key and dropping stability
        # are bit-identical to the (rep, rid, pos)-stable 4-operand sort.
        local = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.uint32)[:, None], (B, Lk)).reshape(-1)
        pos_w = jnp.broadcast_to(
            jnp.arange(Lk, dtype=jnp.uint32)[None, :], (B, Lk)).reshape(-1)
        word = ((local << 17) | (pos_w << 1)
                | flat_dir.astype(jnp.uint32).reshape(-1))
        srep, sword = _sort_pairs(flat_rep, word)
        if not (filter_thr_num == 1 and filter_thr_den == 1):
            lo = jnp.searchsorted(srep, srep, side="left")
            hi = jnp.searchsorted(srep, srep, side="right")
            cnt = (hi - lo).astype(jnp.int32)
            keep = (cnt * filter_thr_den <= n_elems * filter_thr_num) & \
                   (srep != INVALID)
            srep = jnp.where(keep, srep, INVALID)
            srep, sword = _sort_pairs(srep, sword)
            n_elems = jnp.sum(keep).astype(jnp.int32)
        slocal = sword >> 17
        spos = ((sword >> 1) & jnp.uint32(0xFFFF)).astype(jnp.int32)
        sdir = (sword & 1).astype(jnp.int32)
        return {"rep": srep,
                "read_id": first_read_id + slocal.astype(jnp.int32),
                "pos": spos, "dir": sdir, "n_elems": n_elems,
                # matcher side-array layout: (dir<<31 | local<<16 | pos)
                "packed": ((sword & 1) << 31) | (slocal << 16)
                          | spos.astype(jnp.uint32),
                "first_read": jnp.asarray(first_read_id, jnp.int32)}

    rid = (first_read_id + jnp.arange(B, dtype=jnp.int32))[:, None]
    rid = jnp.broadcast_to(rid, (B, Lk)).reshape(-1)
    pos = jnp.broadcast_to(jnp.arange(Lk, dtype=jnp.int32)[None, :],
                           (B, Lk)).reshape(-1)

    srep, srid, spos, sdir = jax.lax.sort(
        (flat_rep, rid, pos, flat_dir), num_keys=3, is_stable=True)

    if not (filter_thr_num == 1 and filter_thr_den == 1):
        lo = jnp.searchsorted(srep, srep, side="left")
        hi = jnp.searchsorted(srep, srep, side="right")
        cnt = (hi - lo).astype(jnp.int32)
        keep = (cnt * filter_thr_den <= n_elems * filter_thr_num) & \
               (srep != INVALID)
        srep = jnp.where(keep, srep, INVALID)
        srep, srid, spos, sdir = jax.lax.sort(
            (srep, srid, spos, sdir), num_keys=3, is_stable=True)
        n_elems = jnp.sum(keep).astype(jnp.int32)

    return {"rep": srep, "read_id": srid, "pos": spos, "dir": sdir,
            "n_elems": n_elems}


@jax.jit
def match_count(qidx: dict, tidx: dict):
    """Phase 1 of matching: target ranges per query element.

    Returns (lo (C,), cum (C+1,), total) — callers sync `total` (they need
    it for status anyway) and size the expansion capacity to the TRUE anchor
    count (pow2-bucketed), instead of always paying for the worst case."""
    qrep = qidx["rep"]
    trep = tidx["rep"]
    # method="sort": one sort-based merge instead of 21 serial gather
    # rounds (and qrep is itself sorted)
    lo = jnp.searchsorted(trep, qrep, side="left",
                          method="sort").astype(jnp.int32)
    hi = jnp.searchsorted(trep, qrep, side="right",
                          method="sort").astype(jnp.int32)
    cnt = jnp.where(qrep != INVALID, hi - lo, 0).astype(jnp.int32)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(cnt).astype(jnp.int32)])
    return lo, cum, cum[-1]


@functools.partial(jax.jit, static_argnames=("cap", "skip_self"))
def match_expand(qidx: dict, tidx: dict, lo, cum, cap: int,
                 skip_self: bool = True):
    """Phase 2: cross-product anchor expansion into (cap,) arrays.

    Anchor order: by (query element order, target occurrence order) — i.e.
    (q_rep, q_read, q_pos, t_read, t_pos), matching the oracle."""
    trep = tidx["rep"]
    total = cum[-1]
    a = jnp.arange(cap, dtype=jnp.int32)
    # drop the TRAILING padding elements' scatters (every INVALID query
    # element sits at the array tail with count 0 and start == total):
    # millions of duplicate-index updates serialize inside a scatter, and
    # their telescoped deltas only touch output rows >= total, which
    # the validity mask kills anyway.  Mid-array zero-count elements keep
    # their scatters (their deltas must telescope into later segments).
    ii = jnp.arange(cum.shape[0] - 1, dtype=jnp.int32)
    starts = jnp.where(ii < qidx["n_elems"], cum[:-1], jnp.int32(cap))

    def fill(field):
        """field[src[a]] WITHOUT the (cap,)-sized gather: per-query-element
        values are piecewise constant along the output, so scattering each
        segment's value DELTA at its start and cumsum-filling reproduces the
        gather with a 4M-delta scatter-add and a cumsum instead of a
        64M-element random gather at the 64M-anchor scale.
        Segments sharing a start (empty ranges) telescope to the LAST
        segment's value — exactly searchsorted(..., 'right') - 1 semantics;
        out-of-range starts (trailing empties at total == cap) drop."""
        f = field.astype(jnp.int32)
        d = jnp.concatenate([f[:1], f[1:] - f[:-1]])
        mark = jnp.zeros(cap, jnp.int32).at[starts].add(d, mode="drop")
        return jnp.cumsum(mark)

    # strategy crossover: scatter-fill costs scale with the UPDATE count
    # (C) and gathers with cap, so small expansions keep the plain
    # searchsorted + gathers (also fewer fixed costs per dispatch)
    if cap < (1 << 23):
        src = jnp.clip(
            jnp.searchsorted(cum, a, side="right",
                             method="sort").astype(jnp.int32) - 1,
            0, cum.shape[0] - 2)

        def fill(field):  # noqa: F811 — small-cap: plain gather
            return field.astype(jnp.int32)[src]

    off = a - fill(cum[:-1])
    tsel = jnp.clip(fill(lo) + off, 0, trep.shape[0] - 1)
    valid = a < jnp.minimum(total, cap)

    q_read = fill(qidx["read_id"])
    if "packed" in tidx:
        # ONE random gather instead of three: (dir, local_read, pos)
        # unpacked from the uint32 side array built at index time
        pk = tidx["packed"][tsel]
        t_read = ((pk >> 16) & jnp.uint32(0x7FFF)).astype(jnp.int32) \
            + tidx["first_read"]
        t_pos = (pk & jnp.uint32(0xFFFF)).astype(jnp.int32)
        t_dir = (pk >> 31).astype(jnp.int32)
    else:
        t_read = tidx["read_id"][tsel]
        t_pos = tidx["pos"][tsel]
        t_dir = tidx["dir"][tsel]
    if skip_self:
        valid &= q_read != t_read
    return {
        "q_read": q_read, "t_read": t_read,
        "q_pos": fill(qidx["pos"]), "t_pos": t_pos,
        "dir": (fill(qidx["dir"]) ^ t_dir).astype(jnp.int32),
        "valid": valid,
    }


@functools.partial(jax.jit, static_argnames=("cap", "skip_self"))
def match_anchors(qidx: dict, tidx: dict, cap: int, skip_self: bool = True):
    """One-shot matching at a fixed capacity (the shard_map path; host
    callers prefer match_count + match_expand with an adaptive cap).

    Returns dict of (cap,) anchor arrays + n_anchors + overflow flag."""
    lo, cum, total = match_count(qidx, tidx)
    anchors = match_expand(qidx, tidx, lo, cum, cap=cap,
                           skip_self=skip_self)
    return anchors, total, total > cap


@functools.partial(jax.jit, static_argnames=(
    "k", "min_residues", "min_overlap_len", "min_bases_per_residue",
    "min_overlap_fraction_num", "min_overlap_fraction_den", "max_gap",
    "pack2"))
def chain_anchors(anchors: dict, k: int, min_residues: int,
                  min_overlap_len: int, min_bases_per_residue: int,
                  min_overlap_fraction_num: int,
                  min_overlap_fraction_den: int, max_gap: int,
                  pack2: bool = False, q_base=0, t_base=0):
    """Triggered chaining.  Returns dict of (cap,) overlap field arrays with
    a validity mask (compaction happens on host where the list is small).

    pack2 (callers set it when read ids < 2^15 and positions < 2^16 — the
    chunked common case): the whole 5-part lexicographic key compresses
    into TWO uint32 words — (qid<<16 | tid<<1 | dir, qp<<16 | st16) where
    st16 = tp for forward and 0xFFFF - tp for reverse strand (16-bit
    complement = descending target order, exactly the signed -tp trick) —
    so the dominant anchor sort runs 2 operands instead of 4.  Same-chain
    deltas are preserved (st16 differences equal the signed st
    differences), so the chain scan below is shared verbatim."""
    if pack2:
        # q_base/t_base: chunk-local id packing (ids are RELATIVE to each
        # index's first read inside the 15-bit key fields, restored on
        # output) — global ids only bound the UNPACKED path, so Gbp-scale
        # runs with >= 2^15 total reads keep the 2-operand sort + fill16
        return _chain_anchors_packed(
            anchors, k, min_residues, min_overlap_len, min_bases_per_residue,
            min_overlap_fraction_num, min_overlap_fraction_den, max_gap,
            q_base, t_base)
    v = anchors["valid"]
    qid = jnp.where(v, anchors["q_read"], I32MAX)
    tid = jnp.where(v, anchors["t_read"], I32MAX)
    # (dir, q_pos) pack into ONE key: positions are < 2^30 (1 Gbp reads),
    # so d * 2^30 + qp orders identically to the (d, qp) pair and the sort
    # runs 4 keys / 5 operands instead of 5 / 7 (validity is recovered from
    # the qid sentinel) — the sort is the mapper's device bottleneck
    dqp = jnp.where(v, (anchors["dir"] << 30) | anchors["q_pos"], I32MAX)
    st = jnp.where(anchors["dir"] == 0, anchors["t_pos"], -anchors["t_pos"])
    st = jnp.where(v, st, I32MAX)

    # 4 operands, all keys: t_pos is recoverable from the signed st key
    # (tp = |st| by construction), so nothing rides along as a value
    qid, tid, dqp, st = jax.lax.sort(
        (qid, tid, dqp, st), num_keys=4, is_stable=True)
    v = qid != I32MAX
    d = jnp.where(v, dqp >> 30, I32MAX)
    qp = jnp.where(v, dqp & ((1 << 30) - 1), I32MAX)
    tp = jnp.where(d == 0, st, -st)        # garbage for invalid rows: masked
    idx = jnp.arange(qid.shape[0], dtype=jnp.int32)
    prev = lambda x: jnp.concatenate([x[:1], x[:-1]])  # noqa: E731
    same = ((qid == prev(qid)) & (tid == prev(tid)) & (d == prev(d))
            & (idx > 0))
    return _chain_scan(same, qid, tid, d, qp, st, tp, v, k, min_residues,
                       min_overlap_len, min_bases_per_residue,
                       min_overlap_fraction_num, min_overlap_fraction_den,
                       max_gap)


def _chain_anchors_packed(anchors, k, min_residues, min_overlap_len,
                          min_bases_per_residue, min_overlap_fraction_num,
                          min_overlap_fraction_den, max_gap,
                          q_base=0, t_base=0):
    """pack2 path of chain_anchors: 2-operand uint32 sort (see docstring)."""
    UMAX = jnp.uint32(0xFFFFFFFF)
    q_base = jnp.asarray(q_base, jnp.int32)
    t_base = jnp.asarray(t_base, jnp.int32)
    v = anchors["valid"]
    qid32 = (anchors["q_read"] - q_base).astype(jnp.uint32)
    tid32 = (anchors["t_read"] - t_base).astype(jnp.uint32)
    d32 = anchors["dir"].astype(jnp.uint32)
    tp32 = anchors["t_pos"].astype(jnp.uint32)
    key1 = jnp.where(v, (qid32 << 16) | (tid32 << 1) | d32, UMAX)
    st16 = jnp.where(anchors["dir"] == 1, jnp.uint32(0xFFFF) - tp32, tp32)
    key2 = jnp.where(v, (anchors["q_pos"].astype(jnp.uint32) << 16) | st16,
                     UMAX)
    # all operands are keys and equal key pairs are fully identical
    # anchors, so an unstable sort is bit-identical in effect — which also
    # makes the Pallas bitonic backend a drop-in (same sorted array)
    key1, key2 = _sort_pairs(key1, key2)
    v = key1 != UMAX
    k1 = key1.astype(jnp.int32)            # valid keys are < 2^31
    d = jnp.where(v, k1 & 1, I32MAX)
    qid = jnp.where(v, (k1 >> 16) + q_base, I32MAX)
    tid = jnp.where(v, ((k1 >> 1) & 0x7FFF) + t_base, I32MAX)
    k2 = key2.astype(jnp.int32)
    qp = jnp.where(v, (k2 >> 16) & 0xFFFF, I32MAX)
    st = jnp.where(v, k2 & 0xFFFF, I32MAX)
    tp = jnp.where(d == 1, 0xFFFF - st, st)  # garbage for invalid: masked
    idx = jnp.arange(k1.shape[0], dtype=jnp.int32)
    prev = lambda x: jnp.concatenate([x[:1], x[:-1]])  # noqa: E731
    same = (key1 == prev(key1)) & (idx > 0)
    return _chain_scan(same, qid, tid, d, qp, st, tp, v, k, min_residues,
                       min_overlap_len, min_bases_per_residue,
                       min_overlap_fraction_num, min_overlap_fraction_den,
                       max_gap, fill16=True)


def _start_fill16(new_chain, val):
    """Forward-fill (val at chain starts) to every row — the gather-free
    replacement for ``val[start_idx]`` when val fits 16 unsigned bits (the
    pack2 scale path).  Random gathers ran several times slower than
    streaming sorts in earlier measurements, so two C-sized value gathers
    dominated the chain stage at 64M anchors.

    Two-level cummax, all streaming ops:
    - within chunks of 2^14: pack (idx_local << 16 | val) at start rows,
      -1 elsewhere; cummax propagates the LATEST start's value (idx_local
      is the high-bits tiebreak; 14+16 bits stays positive int32);
    - across chunks: the per-chunk last packed value (or -1 if a chain
      spans the whole chunk) carries via an exclusive cummax on
      (chunk_idx << 16 | last_val).

    Not jax.lax.associative_scan with a custom pair op: its recursive
    lowering at multi-10M sizes compiled and ran far slower in earlier
    measurements."""
    C = val.shape[0]
    CH = min(C, 1 << 14)
    pad = (-C) % CH
    v16 = jnp.where(new_chain, val & 0xFFFF, -1)
    if pad:
        v16 = jnp.concatenate([v16, jnp.full((pad,), -1, v16.dtype)])
    nc = v16.shape[0] // CH
    v2 = v16.reshape(nc, CH)
    il = jax.lax.broadcasted_iota(jnp.int32, (nc, CH), 1)
    pk = jnp.where(v2 >= 0, (il << 16) | v2, -1)
    ff = jax.lax.cummax(pk, axis=1)
    last = ff[:, -1]
    ci = jnp.arange(nc, dtype=jnp.int32)
    cpk = jnp.where(last >= 0, (ci << 16) | (last & 0xFFFF), -1)
    excl = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                            jax.lax.cummax(cpk)[:-1]])
    out = jnp.where(ff >= 0, ff & 0xFFFF, (excl & 0xFFFF)[:, None])
    return out.reshape(-1)[:C]


def _chain_scan(same, qid, tid, d, qp, st, tp, v, k, min_residues,
                min_overlap_len, min_bases_per_residue,
                min_overlap_fraction_num, min_overlap_fraction_den, max_gap,
                fill16: bool = False):
    """Shared triggered-chain scan over (qid, tid, dir)-grouped, (qp, st)-
    sorted anchors.  `st` must preserve same-chain deltas (signed -tp for
    the unpacked path, 16-bit complement for pack2 — identical deltas).

    fill16: qp/tp of VALID rows fit 16 unsigned bits (pack2 invariant) —
    chain-start values come from the streaming forward-fill instead of
    random gathers.  Invalid rows are forced to the gather path's I32MAX
    so the two paths are bit-identical on the full arrays."""
    C = qid.shape[0]
    idx = jnp.arange(C, dtype=jnp.int32)
    prev = lambda x: jnp.concatenate([x[:1], x[:-1]])  # noqa: E731
    dq = qp - prev(qp)
    dst = st - prev(st)
    cont = same & (dq > 0) & (dq <= max_gap) & (dst > 0) & (dst <= max_gap)
    new_chain = ~cont
    start_idx = jax.lax.cummax(jnp.where(new_chain, idx, 0))
    nxt_new = jnp.concatenate([new_chain[1:], jnp.array([True])])
    is_end = nxt_new & v

    # chain-start values: streaming forward-fill when values fit 16 bits,
    # else gathers on the (monotonic) start indices.  (A segmented
    # forward-fill associative_scan was tried instead and reverted: jax's
    # recursive associative_scan at the 64M scale took minutes to compile
    # and run.)
    s = jnp.clip(start_idx, 0, C - 1)
    n_res = idx - s + 1
    if fill16:
        # invalid rows: an invalid chain starts at an invalid row (UMAX
        # keys sort together at the tail), so the gather path yields
        # qp[s] = tp[s] = I32MAX there; pin the same value here
        q0 = jnp.where(v, _start_fill16(new_chain, qp), I32MAX)
        t_first = jnp.where(v, _start_fill16(new_chain, tp), I32MAX)
    else:
        q0 = qp[s]
        t_first = tp[s]
    q1 = qp + k
    t0 = jnp.where(d == 0, t_first, tp)
    t1 = jnp.where(d == 0, tp, t_first) + k
    qspan = q1 - q0
    tspan = t1 - t0
    olen = jnp.maximum(qspan, tspan)
    ok = (is_end
          & (n_res >= min_residues)
          & (olen >= min_overlap_len)
          & (olen <= min_bases_per_residue * n_res)
          & (jnp.minimum(qspan, tspan) * min_overlap_fraction_den
             >= min_overlap_fraction_num * jnp.maximum(qspan, tspan)))
    return {"q_read": qid, "t_read": tid, "q_start": q0, "q_end": q1,
            "t_start": t0, "t_end": t1, "n_res": n_res, "dir": d,
            "valid": ok}


OVERLAP_FIELDS = ("q_read", "t_read", "q_start", "q_end", "t_start", "t_end",
                  "n_res", "dir")


@jax.jit
def count_valid(out: dict):
    return jnp.sum(out["valid"]).astype(jnp.int32)


@jax.jit
def compact_overlaps(out: dict):
    """Stack the chained-overlap fields with valid rows first (stable, so
    canonical order is preserved) — callers slice [:, :n_valid] and download
    ONE small array instead of cap-sized field arrays (capacity arrays are
    MBs, results are KBs)."""
    key = (~out["valid"]).astype(jnp.int32)
    ops = jax.lax.sort(
        (key,) + tuple(out[f].astype(jnp.int32) for f in OVERLAP_FIELDS),
        num_keys=1, is_stable=True)
    return jnp.stack(ops[1:]), jnp.sum(out["valid"]).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("out_cap",))
def compact_overlaps_gather(out: dict, out_cap: int):
    """Compaction for LARGE anchor capacities: one 2-operand index sort
    plus 8 gathers of only the first out_cap rows, instead of dragging all
    9 field arrays through the sort (callers pick out_cap as the pow2
    bucket of the already-synced valid count, so results are identical to
    compact_overlaps[:, :n_valid])."""
    key = (~out["valid"]).astype(jnp.int32)
    idx = jnp.arange(key.shape[0], dtype=jnp.int32)
    _, idx_sorted = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    sel = idx_sorted[:out_cap]
    return jnp.stack([out[f].astype(jnp.int32)[sel]
                      for f in OVERLAP_FIELDS])
