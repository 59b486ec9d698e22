"""All-vs-all minimizer overlap mapper — the cudamapper equivalent.

API mirrors the reference surface (reference: cudamapper/include/
claragenomics/cudamapper/{index,matcher,overlapper}.hpp [U]):
``Index.create_index`` / ``Matcher.create_matcher`` / ``Overlapper`` plus an
all-vs-all driver with index batching, host index caching and deterministic
PAF output.

Device behavior: sketching/sorting/matching/chaining are single XLA
programs over padded batches (ops/sketch.py, ops/map_ops.py); the reference's
per-GPU worker threads become a sequential (query-batch x target-batch) loop
whose device work is async-dispatched, with results merged in canonical
Overlap.key() order so output is bit-identical for any batching.
"""

from collections import Counter
from dataclasses import dataclass, replace
from fractions import Fraction

import numpy as np

import jax.numpy as jnp

from ..core.bufferplan import anchor_capacity
from ..core.config import MapperConfig
from ..core.status import StatusType
from ..core.types import Overlap
from ..io.fasta import FastaParser
from ..io.paf import format_paf_row
from ..ops import map_ops, sketch
from ..utils.genomeutils import encode, reverse_complement
from ..utils.mathutils import round_up
from ..utils.profiling import trace_range


def kmerize(seq: str, k: int) -> Counter:
    """Multiset of the k-mers of seq (reference: cudamapper_utils.cpp
    kmerize [U]; host-side helper, used by overlap-end rescue)."""
    if k <= 0 or len(seq) < k:
        return Counter()
    return Counter(seq[i: i + k] for i in range(len(seq) - k + 1))


#: ASCII -> 2-bit base code for the vectorized similarity path (uppercase
#: ACGT only; anything else routes to the exact Counter fallback)
_SIM_CODE = np.full(256, -1, dtype=np.int64)
for _i, _c in enumerate("ACGT"):
    _SIM_CODE[ord(_c)] = _i


def _kmer_hist(codes: np.ndarray, k: int) -> np.ndarray:
    """Histogram of 2-bit-packed k-mer values over 4**k bins."""
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    vals = win @ (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    return np.bincount(vals, minlength=4 ** k)


def sequence_similarity(a: str, b: str, k: int = 4) -> float:
    """Shared-k-mer fraction: |kmers(a) & kmers(b)| / min(#kmers) in [0, 1]
    (reference: cudamapper_utils similarity helper [U]; exact formula is OURS,
    documented here: multiset intersection over the shorter k-mer count).

    Long pure-uppercase-ACGT inputs with k <= 8 take a vectorized path
    (2-bit k-mer codes + bincount + elementwise min); short or non-ACGT
    inputs keep the string-multiset Counter, which measures faster below
    a few hundred bases (numpy call overhead dominates tiny flanks — the
    per-overlap scale fix for rescue_overlap_ends is the BATCHED
    _similarity_batch below, not this function)."""
    if k <= 0 or len(a) < k or len(b) < k:
        return 0.0
    if k <= 8 and min(len(a), len(b)) >= 256:
        ca = _SIM_CODE[np.frombuffer(a.encode(), dtype=np.uint8)]
        cb = _SIM_CODE[np.frombuffer(b.encode(), dtype=np.uint8)]
        if ca.min() >= 0 and cb.min() >= 0:
            shared = int(np.minimum(_kmer_hist(ca, k), _kmer_hist(cb, k))
                         .sum())
            return shared / min(len(a) - k + 1, len(b) - k + 1)
    ka, kb = kmerize(a, k), kmerize(b, k)
    if not ka or not kb:
        return 0.0
    shared = sum((ka & kb).values())
    return shared / min(sum(ka.values()), sum(kb.values()))


def _similarity_batch(pairs: list[tuple[str, str]], k: int) -> np.ndarray:
    """sequence_similarity over many (a, b) pairs at once — the scale path
    for rescue_overlap_ends (one Counter multiset per flank cost ~35 us;
    at ONT scale the rescue pass has 10^5..10^6 flank pairs).

    Pure-uppercase-ACGT pairs batch through padded 2-bit k-mer codes and
    one flat bincount per row chunk; anything else falls back to the
    Counter path per pair.  Results equal sequence_similarity exactly."""
    n = len(pairs)
    sims = np.zeros(n, dtype=np.float64)
    if n == 0:
        return sims

    def fallback(idxs):
        for i in idxs:
            sims[i] = sequence_similarity(*pairs[i], k)

    if k <= 0 or k > 8:
        fallback(range(n))
        return sims
    try:                                    # one encode of ALL flanks
        a_bytes = "".join(a for a, _ in pairs).encode("ascii")
        b_bytes = "".join(b for _, b in pairs).encode("ascii")
    except UnicodeEncodeError:              # exotic chars: exact slow path
        fallback(range(n))
        return sims
    la = np.fromiter((len(a) for a, _ in pairs), np.int64, n)
    lb = np.fromiter((len(b) for _, b in pairs), np.int64, n)
    ca = _SIM_CODE[np.frombuffer(a_bytes, dtype=np.uint8)]
    cb = _SIM_CODE[np.frombuffer(b_bytes, dtype=np.uint8)]

    def seg_ok(codes, lens):
        """per-row all-ACGT flag, without per-row numpy calls"""
        ok = np.ones(n, dtype=bool)
        nz = np.flatnonzero(lens > 0)
        if nz.size:
            # reduceat over the NONZERO rows' offsets only: they are
            # strictly increasing and in-bounds, and each segment then
            # spans exactly that row's codes (empty rows contribute no
            # codes), so the last row's final character is never dropped
            offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
            ok[nz] = np.minimum.reduceat(codes, offs[nz]) >= 0
        return ok

    fast = (la >= k) & (lb >= k) & seg_ok(ca, la) & seg_ok(cb, lb)
    fallback(np.flatnonzero(~fast & (la >= k) & (lb >= k)))
    fi = np.flatnonzero(fast)
    if fi.size == 0:
        return sims
    nbins = 4 ** k
    pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)

    def row_vals(codes, lens):
        """(sum nwin,) valid k-mer values + per-row window counts: windows
        slide over the FLAT concatenation once; per-row windows are the
        offs[i]..offs[i]+len-k slice (cross-segment windows never get
        selected), so no padded matrix or scatter is ever built."""
        if codes.size < k:
            return np.zeros(0, np.int64), np.zeros(fi.size, np.int64)
        flat = np.lib.stride_tricks.sliding_window_view(codes, k) @ pows
        offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
        nwin = lens[fi] - k + 1
        total = int(nwin.sum())
        starts = np.concatenate([[0], np.cumsum(nwin)[:-1]])
        local = np.arange(total, dtype=np.int64) - np.repeat(starts, nwin)
        return flat[np.repeat(offs[fi], nwin) + local], nwin

    va, na = row_vals(ca, la)
    vb, nb = row_vals(cb, lb)
    # small slices keep the two dense histograms cache-resident (the
    # min+sum over them is the memory-bound step): ~0.5M bins ~= 4 MB
    CHUNK = max(1, (1 << 19) // nbins)
    ra = np.concatenate([[0], np.cumsum(na)])
    rb = np.concatenate([[0], np.cumsum(nb)])
    rowid_a = np.repeat(np.arange(fi.size) % CHUNK, na)
    rowid_b = np.repeat(np.arange(fi.size) % CHUNK, nb)
    for s in range(0, fi.size, CHUNK):
        e = min(s + CHUNK, fi.size)
        ha = np.bincount(rowid_a[ra[s]:ra[e]] * nbins + va[ra[s]:ra[e]],
                         minlength=(e - s) * nbins).reshape(e - s, nbins)
        hb = np.bincount(rowid_b[rb[s]:rb[e]] * nbins + vb[rb[s]:rb[e]],
                         minlength=(e - s) * nbins).reshape(e - s, nbins)
        shared = np.minimum(ha, hb).sum(axis=1)
        sims[fi[s:e]] = shared / np.minimum(na[s:e], nb[s:e])
    return sims


class Index:
    """Minimizer index over parser reads [first, past_last)
    (reference: Index [U])."""

    def __init__(self, arrays: dict, first_read_id: int, read_lengths: list[int],
                 read_names: list[str]):
        self._arrays = arrays
        self.first_read_id = first_read_id
        self.read_lengths = read_lengths
        self.read_names = read_names

    @classmethod
    def create_index(cls, parser: FastaParser, first_read: int,
                     past_last_read: int, cfg: MapperConfig) -> "Index":
        seqs = [parser.get_sequence_by_id(i).seq
                for i in range(first_read, past_last_read)]
        names = [parser.get_sequence_by_id(i).name
                 for i in range(first_read, past_last_read)]
        k, w = cfg.kmer_size, cfg.window_size
        # pow2 shape buckets: one XLA executable serves many batch sizes
        Lmax = max(max((len(s) for s in seqs), default=k), k) + 1
        L = max(64, 1 << (Lmax - 1).bit_length())
        B0 = len(seqs)
        B = max(8, 1 << (B0 - 1).bit_length())
        with trace_range("mapper.sketch"):
            # sub-ranges split the stage: host encode+pack vs transfer
            # vs device kernel.
            with trace_range("mapper.sketch.encode"):
                # per-read translate-table encode; measured faster on the
                # host than a concatenated single translate (the 25 MB
                # string join costs more than 2.5 k call overheads)
                reads = np.full((B, L), -1, dtype=np.int8)
                lens = np.zeros(B, dtype=np.int32)
                for i, s in enumerate(seqs):
                    reads[i, : len(s)] = encode(s)
                    lens[i] = len(s)
            # 2-bit packed transfer: 4x fewer host-to-device bytes than
            # the byte-per-base matrix; N positions ride as a sparse
            # pow2-padded list (OOB rows drop inside the kernel).  N-dense
            # chunks (assembly gaps can run >10% N) would make the 8-byte
            # index pairs BIGGER than the byte matrix — keep the plain
            # path when the sparse list stops paying (~9% of B*L).
            # Pack (and ship) only the USED rows/cols in finer 256/128-
            # multiple buckets — the pow2 (B, L) shape is ~60 % padding at
            # 10 kb reads; the device re-pads (zeros == clipped 'A', and
            # the kernel's pos < n mask invalidates every tail k-mer).
            B0r = min(B, -(-max(B0, 1) // 256) * 256)
            C4 = (int(lens.max()) + 3) // 4 if B0 else 1
            C4r = min(L // 4, -(-max(C4, 1) // 128) * 128)
            with trace_range("mapper.sketch.pack"):
                packed, n_rows, n_cols = sketch.pack_reads(
                    reads[:B0r, :C4r * 4], lens[:B0r])
            if 8 * len(n_rows) > (B0r * C4r * 3):
                with trace_range("mapper.sketch.xfer"):
                    reads_d = jnp.asarray(reads)
                    lens_d = jnp.asarray(lens)
                with trace_range("mapper.sketch.kernel"):
                    rep, dirs, is_min = sketch.sketch_batch(
                        reads_d, lens_d, k, w, cfg.hash_representations)
            else:
                npad = max(8, 1 << (max(len(n_rows), 1) - 1).bit_length())
                n_rows = np.pad(n_rows, (0, npad - len(n_rows)),
                                constant_values=B)
                n_cols = np.pad(n_cols, (0, npad - len(n_cols)))
                with trace_range("mapper.sketch.xfer"):
                    packed_d = jnp.asarray(packed)
                    if packed.shape != (B, L // 4):
                        packed_d = jnp.pad(
                            packed_d, ((0, B - B0r), (0, L // 4 - C4r)))
                    n_rows_d = jnp.asarray(n_rows)
                    n_cols_d = jnp.asarray(n_cols)
                    lens_d = jnp.asarray(lens)
                with trace_range("mapper.sketch.kernel"):
                    rep, dirs, is_min = sketch.sketch_batch_packed(
                        packed_d, n_rows_d, n_cols_d, lens_d, k, w,
                        cfg.hash_representations)
        frac = Fraction(cfg.filtering_parameter).limit_denominator(10**6)
        # packed side array fits when local read ids take < 2^15 and
        # positions < 2^16 (B/L are the pow2-padded shapes)
        with_packed = B <= (1 << 15) and L <= (1 << 16)
        with trace_range("mapper.index_sort"):
            arrays = map_ops.build_index(
                rep, dirs, is_min, jnp.int32(first_read),
                filter_thr_num=frac.numerator,
                filter_thr_den=frac.denominator,
                with_packed=with_packed)
        # COMPACT the element arrays: build_index sorts INVALID reps to the
        # back, so slicing to the pow2 bucket of the true element count
        # drops the ~(1 - 2/(w+1)) non-minimizer slots.  Downstream match
        # sorts/scans then run on ~n_elems rows instead of B*L (a 16x cut
        # at w=15) — this, not the kernels, dominated mapping at 100 Mbp.
        n = int(arrays["n_elems"])
        Cp = max(1024, 1 << (max(n, 1) - 1).bit_length())
        if Cp < arrays["rep"].shape[0]:
            arrays = {k: (v if np.ndim(v) == 0 or k == "n_elems"
                          else v[:Cp])
                      for k, v in arrays.items()}
        # arrays stay DEVICE-resident: only final compacted overlaps leave
        # the device (Overlapper.get_overlaps).
        return cls(arrays, first_read, [len(s) for s in seqs], names)

    # --- reference-parity array views (materialize on demand) ------------
    @property
    def n_elems(self) -> int:
        return int(self._arrays["n_elems"])

    def representations(self) -> np.ndarray:
        return np.asarray(self._arrays["rep"][: self.n_elems])

    def read_ids(self) -> np.ndarray:
        return np.asarray(self._arrays["read_id"][: self.n_elems])

    def positions_in_reads(self) -> np.ndarray:
        return np.asarray(self._arrays["pos"][: self.n_elems])

    def directions_of_reads(self) -> np.ndarray:
        return np.asarray(self._arrays["dir"][: self.n_elems])

    def unique_representations(self) -> np.ndarray:
        return np.unique(self.representations())

    def first_occurrence_of_representations(self) -> np.ndarray:
        _, first = np.unique(self.representations(), return_index=True)
        return np.sort(first)

    def number_of_reads(self) -> int:
        return len(self.read_lengths)


class IndexCache:
    """Host-side index cache (reference: src/index_cache.cpp,
    index_host_copy.cu [U]) — avoids re-sketching a read range reused across
    (query batch x target batch) pairs.

    `store_dir` adds the on-disk layer (parallel/index_store.py, the
    IndexHostCopy-persisted-to-disk analog): misses first try the
    content-keyed .npz store, and freshly built indices are saved to it —
    a compute cache across runs AND a resume point."""

    def __init__(self, max_entries: int = 64, store_dir: str | None = None):
        self._cache: dict[tuple, Index] = {}
        self._order: list[tuple] = []
        self._max = max_entries
        self.store_dir = store_dir
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    def get_or_create(self, parser, first: int, past_last: int,
                      cfg: MapperConfig) -> Index:
        key = (id(parser), first, past_last, cfg.kmer_size, cfg.window_size,
               cfg.hash_representations, cfg.filtering_parameter)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        idx = None
        if self.store_dir:
            from ..parallel.index_store import index_key, load_index
            skey = index_key(parser, first, past_last, cfg)
            idx = load_index(self.store_dir, skey)
            if idx is not None:
                self.disk_hits += 1
                # loaded arrays are host numpy; move them on-device once so
                # every (q, t) pair reuse doesn't re-upload
                idx._arrays = {
                    k: (v if k == "n_elems" else jnp.asarray(v))
                    for k, v in idx._arrays.items()}
        if idx is None:
            idx = Index.create_index(parser, first, past_last, cfg)
            if self.store_dir:
                from ..parallel.index_store import index_key, save_index
                save_index(idx, self.store_dir,
                           index_key(parser, first, past_last, cfg))
        if len(self._order) >= self._max:
            old = self._order.pop(0)
            self._cache.pop(old, None)
        self._cache[key] = idx
        self._order.append(key)
        return idx


class Matcher:
    """Anchor generation between two indices (reference: Matcher [U])."""

    def __init__(self, anchors: dict, total_d, cap_used: int, hard_cap: int):
        self._anchors = anchors
        self._total_d = total_d        # device scalar until first read
        self.cap_used = cap_used
        self._hard_cap = hard_cap

    @property
    def n_anchors(self) -> int:
        """True anchor count.  Syncs the device scalar on first access —
        callers on the hot path read it AFTER downstream results so the
        round trip is free (the count is long since computed)."""
        if not isinstance(self._total_d, int):
            self._total_d = int(self._total_d)
        return self._total_d

    @property
    def overflow(self) -> bool:
        return self.n_anchors > self._hard_cap

    @property
    def status(self) -> StatusType:
        return (StatusType.EXCEEDED_MAX_ANCHORS if self.overflow
                else StatusType.SUCCESS)

    @property
    def truncated(self) -> bool:
        """True when the capacity-hint dispatch dropped anchors even though
        the hard cap admits them — the caller must redo this pair with the
        exact capacity (map_all_vs_all's ratchet path)."""
        return self.cap_used < self.n_anchors <= self._hard_cap

    @classmethod
    def create_matcher(cls, query_index: Index, target_index: Index,
                       cfg: MapperConfig, cap: int | None = None,
                       mesh=None, cap_hint: int | None = None) -> "Matcher":
        """`mesh`: optional jax.sharding.Mesh with a 'rep' axis — the target
        index is split into sorted-representation blocks across it and
        per-shard anchors are all-gathered (parallel/shard.py); anchor sets
        (and all downstream output) are identical to the 1-device path.

        `cap_hint`: expansion capacity to use WITHOUT syncing the true
        anchor count first (a blocking int(total) costs one host-device
        round trip per (q, t) pair).  Callers check
        `truncated` after downstream results land (the count has computed
        by then, so the read is latency-free) and redo the rare pair whose
        hint was too small."""
        if cap is None:
            cap = round_up(
                max(query_index._arrays["rep"].shape[0] * 4, 1024), 128)
        with trace_range("mapper.match"):
            qj = {k: jnp.asarray(v) for k, v in query_index._arrays.items()}
            tj = {k: jnp.asarray(v) for k, v in target_index._arrays.items()}
            with trace_range("mapper.match.count"):
                lo, cum, total_d = map_ops.match_count(qj, tj)
            if cap_hint is not None:
                cap_eff = min(cap, max(1024, cap_hint))
                total: int | jnp.ndarray = total_d     # deferred sync
            else:
                total = int(total_d)
                # expansion capacity = pow2 bucket of the TRUE anchor count
                # (clamped to the caller's cap): downstream chain/compact
                # work scales with the real data, not the worst case
                cap_eff = min(cap, max(1024,
                                       1 << (max(total, 1) - 1).bit_length()))
            if mesh is not None and mesh.shape.get("rep", 1) > 1:
                from ..parallel.shard import sharded_anchors
                anchors, _, _ = sharded_anchors(
                    query_index._arrays, target_index._arrays, cfg, mesh,
                    cap=cap_eff)
            else:
                with trace_range("mapper.match.expand"):
                    anchors = map_ops.match_expand(
                        qj, tj, lo, cum, cap=cap_eff,
                        skip_self=cfg.skip_self_mappings)
        # anchors stay device-resident; chaining consumes them in place
        return cls(anchors, total, cap_eff, cap)

    def anchors(self) -> dict:
        return self._anchors

    def anchors_host(self) -> dict:
        return {k: np.asarray(v) for k, v in self._anchors.items()}


def _pack2_ok(qidx: "Index", tidx: "Index") -> bool:
    """True when the CHUNK-LOCAL read ids fit 15 bits and every position
    16 bits on both sides — the precondition for chain_anchors' 2-operand
    packed sort with q_base/t_base id rebasing (so Gbp-scale runs whose
    GLOBAL ids exceed 2^15 keep the fast path; chunk sizes are bounded by
    the index budget and never approach 2^15 reads in practice)."""
    return (len(qidx.read_lengths) <= (1 << 15)
            and len(tidx.read_lengths) <= (1 << 15)
            and max(qidx.read_lengths, default=0) <= (1 << 16)
            and max(tidx.read_lengths, default=0) <= (1 << 16))


def _pack2_ok_global(qidx: "Index", tidx: "Index") -> bool:
    """The stricter GLOBAL-id variant for paths that do not thread the
    q_base/t_base rebase operands (the rep-mesh routed chain)."""
    return (qidx.first_read_id + len(qidx.read_lengths) <= (1 << 15)
            and tidx.first_read_id + len(tidx.read_lengths) <= (1 << 15)
            and max(qidx.read_lengths, default=0) <= (1 << 16)
            and max(tidx.read_lengths, default=0) <= (1 << 16))


def _canonical_order(rows: np.ndarray) -> np.ndarray:
    """Overlap.key() order as one numpy lexsort over (8, n) overlap rows
    (lexsort keys are least-significant first)."""
    return np.lexsort((rows[5], rows[3], rows[4], rows[2], rows[7],
                       rows[1], rows[0]))


class Overlapper:
    """Triggered chaining + filters (reference: OverlapperTriggered [U])."""

    @staticmethod
    def get_overlap_rows(anchors: dict, cfg: MapperConfig,
                         pack2: bool = False, q_base: int = 0,
                         t_base: int = 0) -> np.ndarray:
        """Chained overlaps as an (8, n) int32 array in canonical
        Overlap.key() order (rows: q_read, t_read, q_start, q_end, t_start,
        t_end, n_residues, strand01).  The array form is the scale path —
        per-overlap Python objects would dominate at millions of rows.

        pack2: caller asserts read ids < 2^15 and positions < 2^16 (see
        _pack2_ok) — the chain sort then runs 2 uint32 operands instead
        of 4 int32 ones."""
        return Overlapper.compact_materialize(
            Overlapper.get_overlap_rows_dispatch(
                anchors, cfg, pack2=pack2, q_base=q_base, t_base=t_base))

    @staticmethod
    def get_overlap_rows_dispatch(anchors: dict, cfg: MapperConfig,
                                  pack2: bool = False, q_base: int = 0,
                                  t_base: int = 0,
                                  nv_hint: int | None = None):
        """Async half of get_overlap_rows: dispatch chain + compaction,
        return a pending handle for Overlapper.compact_materialize.  The
        pair loops sync each pair ONE PAIR BEHIND so the download overlaps
        the next pair's device work; nv_hint pre-starts the row download
        (see compact_dispatch)."""
        frac = Fraction(cfg.min_overlap_fraction).limit_denominator(10**6)
        with trace_range("mapper.chain"):
            out = map_ops.chain_anchors(
                {k: jnp.asarray(v) for k, v in anchors.items()},
                k=cfg.kmer_size, min_residues=cfg.min_residues,
                min_overlap_len=cfg.min_overlap_len,
                min_bases_per_residue=cfg.min_bases_per_residue,
                min_overlap_fraction_num=frac.numerator,
                min_overlap_fraction_den=frac.denominator,
                max_gap=cfg.max_anchor_gap, pack2=pack2,
                q_base=q_base, t_base=t_base)
        return Overlapper.compact_dispatch(out, nv_hint=nv_hint)

    @staticmethod
    def compact_dispatch(out: dict, mesh=None, nv_hint: int | None = None):
        """Dispatch the compaction WITHOUT syncing; returns an opaque
        pending handle for compact_materialize.  The split lets the
        pair loop pipeline the blocking count+download one pair behind
        the next pair's device work — at Gbp scale (~1156 chunk pairs)
        the per-pair sync serialization, not the kernels, dominated the
        wall (watch.log: 745 s warm with 'compact' soaking 633 s of
        first-sync roll-up).

        nv_hint: expected overlap count (the pair loop ratchets the max
        seen so far).  When given, a pow2-capped row slice starts its
        device->host copy ASYNCHRONOUSLY at dispatch time, so the
        materialize step pays ~zero download latency unless the hint was
        too small (verified against the true count; rare misses redo)."""
        import jax
        repl = None
        if mesh is not None and jax.process_count() > 1:
            from jax.sharding import NamedSharding, PartitionSpec
            repl = NamedSharding(mesh, PartitionSpec())
        with trace_range("mapper.compact"):
            C = out["valid"].shape[0]
            if C <= (1 << 21):
                # small capacity: the fused 9-operand compaction sort is one
                # dispatch + one sync
                fn = (map_ops.compact_overlaps if repl is None else
                      jax.jit(map_ops.compact_overlaps, out_shardings=repl))
                stacked, nv_d = fn(out)
                kind = "sorted"
            else:
                # large capacity: index-sort + gathers of just the valid
                # bucket beats dragging 9 cap-sized operands through a
                # sort; without a hint the gather is sized at materialize
                # time (one pair later), still overlapped with the NEXT
                # pair's device work
                nv_d = map_ops.count_valid(out)
                stacked = None
                kind = "gather"
            sl = cap_h = None
            if nv_hint is not None and repl is None:
                cap_h = min(C, max(128,
                                   1 << (max(nv_hint, 1) - 1).bit_length()))
                if kind == "gather":
                    stacked = map_ops.compact_overlaps_gather(out, cap_h)
                    sl = stacked
                else:
                    sl = stacked[:, :cap_h]
                try:
                    sl.copy_to_host_async()
                except AttributeError:   # non-jax arrays in tests
                    pass
            return (kind, stacked, nv_d, out, repl, sl, cap_h)

    @staticmethod
    def compact_materialize(pending) -> np.ndarray:
        """Sync + download a compact_dispatch handle to the canonical
        (8, n_valid) host rows."""
        import jax
        kind, stacked, nv_d, out, repl, sl, cap_h = pending
        with trace_range("mapper.compact"):
            nv = int(nv_d)
            if sl is not None and nv <= cap_h:
                rows = np.asarray(sl)[:, :nv]     # async copy done/cheap
            elif kind == "gather":
                C = out["valid"].shape[0]
                cap_o = min(C, max(128, 1 << (max(nv, 1) - 1).bit_length()))
                if repl is None:
                    stacked = map_ops.compact_overlaps_gather(out, cap_o)
                else:
                    stacked = jax.jit(
                        lambda o: map_ops.compact_overlaps_gather(o, cap_o),
                        out_shardings=repl)(out)
                rows = np.asarray(stacked[:, :nv])
            else:
                rows = np.asarray(stacked[:, :nv])    # ONE small download
        return rows[:, _canonical_order(rows)]

    @staticmethod
    def compact_rows(out: dict, mesh=None) -> np.ndarray:
        """Compact a masked chain-output dict (device-resident) to the
        canonical (8, n_valid) host array — one small download.

        `mesh`: required when `out` spans multiple PROCESSES (a routed
        multi-host run): the compaction then pins replicated out-shardings
        so every host can materialize the result (SURVEY §5.8's
        deterministic per-host merge — each host holds the identical full
        row set, so downstream PAF output is host-independent)."""
        return Overlapper.compact_materialize(
            Overlapper.compact_dispatch(out, mesh=mesh))

    @staticmethod
    def compact_rows_local(out: dict, mesh) -> dict:
        """Per-shard compaction of a routed chain output dict — the
        pod-scale alternative to compact_rows(mesh=...): each 'rep' shard
        compacts ON ITS OWN DEVICE and only locally-addressable results
        reach this host, so no host ever materializes the global overlap
        set (SURVEY §5.8 "per-host files merged deterministically").

        Returns {rep_shard_index: (8, n_valid) canonical rows} for the
        shards whose PRIMARY (replica-0) copy is addressable from this
        process — across processes each shard appears exactly once.
        Because routing assigns each shard a disjoint ascending query-id
        range (parallel/shard._routed_match_chain), concatenating the
        values in shard-index order reproduces compact_rows(out) exactly
        (asserted by tests and the 2-process Gloo worker)."""
        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        n_rep = mesh.shape["rep"]

        def body(o):
            stacked, nv = map_ops.compact_overlaps(o)
            # replicate the per-shard counts so every process reads them
            # without owning remote shards (they are n_rep ints)
            nv_all = jax.lax.all_gather(nv.reshape(1), "rep",
                                        axis=0).reshape(-1)
            return stacked, nv_all

        with trace_range("mapper.compact_local"):
            fn = jax.jit(shard_map(
                body, mesh=mesh,
                in_specs=({k: P(("rep",)) for k in out},),
                out_specs=(P(None, ("rep",)), P()),
                check_vma=False))
            stacked, nv = fn(out)
            counts = np.asarray(nv.addressable_data(0))
            cap_local = stacked.shape[1] // n_rep
            rows_by_shard = {}
            for s in stacked.addressable_shards:
                if s.replica_id != 0:
                    continue  # replicas over the data/sp axes write nothing
                r = (s.index[1].start or 0) // cap_local
                rows = np.asarray(s.data)[:, :int(counts[r])]
                rows_by_shard[r] = rows[:, _canonical_order(rows)]
        return rows_by_shard

    @staticmethod
    def rows_to_overlaps(rows: np.ndarray) -> list[Overlap]:
        cols = rows.T.tolist()              # one bulk int conversion
        return [Overlap(c[0], c[1], c[2], c[3], c[4], c[5], c[6],
                        "+" if c[7] == 0 else "-") for c in cols]

    @staticmethod
    def get_overlaps(anchors: dict, cfg: MapperConfig,
                     pack2: bool = False, q_base: int = 0,
                     t_base: int = 0) -> list[Overlap]:
        return Overlapper.rows_to_overlaps(
            Overlapper.get_overlap_rows(anchors, cfg, pack2=pack2,
                                        q_base=q_base, t_base=t_base))

    @staticmethod
    def filter_overlaps(overlaps: list[Overlap], min_residues: int = 0,
                        min_overlap_len: int = 0) -> list[Overlap]:
        """Post-filter (reference: Overlapper::filter_overlaps [U]): drop
        overlaps below the residue / length thresholds.  Order-preserving."""
        return [o for o in overlaps
                if o.num_residues >= min_residues
                and (o.query_end_position_in_read
                     - o.query_start_position_in_read) >= min_overlap_len
                and (o.target_end_position_in_read
                     - o.target_start_position_in_read) >= min_overlap_len]

    @staticmethod
    def fuse_overlaps(overlaps: list[Overlap],
                      max_gap: int = 500) -> list[Overlap]:
        """Merge runs of overlaps on the same (query, target, strand) whose
        successive query/target gaps both fit within max_gap (reference:
        OverlapperTriggered fuses adjacent candidate overlaps [U]; exact
        rule OURS, documented here).  Canonical rule: overlaps are taken in
        Overlap.key() order; a candidate fuses into the previous fused
        overlap when query gap <= max_gap and strand-oriented target gap
        <= max_gap (negative gaps, i.e. overlapping spans, always fuse).
        The fused overlap covers the union of spans, sums num_residues and
        drops any per-part CIGAR."""
        out: list[Overlap] = []
        for o in sorted(overlaps, key=lambda o: o.key()):
            last = out[-1] if out else None
            if (last is not None
                    and last.query_read_id == o.query_read_id
                    and last.target_read_id == o.target_read_id
                    and last.relative_strand == o.relative_strand):
                qgap = (o.query_start_position_in_read
                        - last.query_end_position_in_read)
                if o.relative_strand == "+":
                    tgap = (o.target_start_position_in_read
                            - last.target_end_position_in_read)
                else:
                    # '-' chains walk the target backwards in query order
                    tgap = (last.target_start_position_in_read
                            - o.target_end_position_in_read)
                if qgap <= max_gap and tgap <= max_gap:
                    out[-1] = replace(
                        last,
                        query_end_position_in_read=max(
                            last.query_end_position_in_read,
                            o.query_end_position_in_read),
                        target_start_position_in_read=min(
                            last.target_start_position_in_read,
                            o.target_start_position_in_read),
                        target_end_position_in_read=max(
                            last.target_end_position_in_read,
                            o.target_end_position_in_read),
                        num_residues=last.num_residues + o.num_residues,
                        cigar="")
                    continue
            out.append(replace(o))
        return out

    @staticmethod
    def fuse_overlap_rows(rows: np.ndarray, max_gap: int = 500) -> np.ndarray:
        """fuse_overlaps on the (8, n) canonical-order row array — the
        scale path (no per-overlap dataclasses; the Python loop only walks
        group members, and row arithmetic is plain ints).  Result rows
        equal fuse_overlaps applied to the same overlaps (differential-
        tested), in the same canonical order: fusion only merges adjacent
        same-group rows, so group-local merging preserves global order."""
        n = rows.shape[1]
        if n == 0:
            return rows
        qid, tid, st = rows[0], rows[1], rows[7]
        new_grp = np.ones(n, dtype=bool)
        new_grp[1:] = ((qid[1:] != qid[:-1]) | (tid[1:] != tid[:-1])
                       | (st[1:] != st[:-1]))
        grp_starts = np.flatnonzero(new_grp)
        grp_ends = np.append(grp_starts[1:], n)
        out_cols: list[np.ndarray] = []
        R = np.ascontiguousarray(rows.T)        # (n, 8) row-wise
        for s, e in zip(grp_starts, grp_ends):
            if e - s == 1:
                out_cols.append(R[s])
                continue
            fused = R[s].copy()
            fwd = fused[7] == 0
            for i in range(s + 1, e):
                c = R[i]
                qgap = c[2] - fused[3]
                tgap = (c[4] - fused[5]) if fwd else (fused[4] - c[5])
                if qgap <= max_gap and tgap <= max_gap:
                    fused[3] = max(fused[3], c[3])
                    fused[4] = min(fused[4], c[4])
                    fused[5] = max(fused[5], c[5])
                    fused[6] += c[6]
                else:
                    out_cols.append(fused)
                    fused = c.copy()
            out_cols.append(fused)
        return np.stack(out_cols, axis=1)

    @staticmethod
    def rescue_overlap_ends(overlaps: list[Overlap], parser: FastaParser,
                            extension: int = 50,
                            required_similarity: float = 0.85,
                            k: int = 4) -> list[Overlap]:
        """Extend overlap ends into the unaligned read flanks when the two
        flanks look alike (reference: Overlapper::rescue_overlap_ends [U]).

        Canonical rule (OURS, documented): each end extends by
        e = min(extension, query flank, target flank) iff e >= k and
        sequence_similarity(query flank, strand-oriented target flank, k)
        >= required_similarity.  '-' overlaps pair the query head with the
        reverse-complemented target TAIL flank and vice versa (PAF keeps
        target coordinates on the forward strand).

        The two ends read disjoint coordinates, so all candidate flank
        pairs are collected first and scored in ONE _similarity_batch
        call (the per-overlap Counter loop dominated rescue at scale)."""
        cand: list[tuple[int, bool, int]] = []   # (overlap idx, is_head, e)
        flanks: list[tuple[str, str]] = []
        spans = []
        for bi, o in enumerate(overlaps):
            q = parser.get_sequence_by_id(o.query_read_id).seq
            t = parser.get_sequence_by_id(o.target_read_id).seq
            qs, qe = (o.query_start_position_in_read,
                      o.query_end_position_in_read)
            ts, te = (o.target_start_position_in_read,
                      o.target_end_position_in_read)
            spans.append([qs, qe, ts, te])
            fwd = o.relative_strand == "+"

            # head of the query pairs with target start (+) / target end (-)
            e = min(extension, qs, ts if fwd else len(t) - te)
            if e >= k:
                qf = q[qs - e: qs]
                tf = (t[ts - e: ts] if fwd
                      else reverse_complement(t[te: te + e]))
                cand.append((bi, True, e))
                flanks.append((qf, tf))
            # tail of the query pairs with target end (+) / target start (-)
            e = min(extension, len(q) - qe, len(t) - te if fwd else ts)
            if e >= k:
                qf = q[qe: qe + e]
                tf = (t[te: te + e] if fwd
                      else reverse_complement(t[ts - e: ts]))
                cand.append((bi, False, e))
                flanks.append((qf, tf))

        sims = _similarity_batch(flanks, k)
        for (bi, is_head, e), sim in zip(cand, sims):
            if sim < required_similarity:
                continue
            fwd = overlaps[bi].relative_strand == "+"
            sp = spans[bi]
            if is_head:
                sp[0] -= e                  # qs
                if fwd:
                    sp[2] -= e              # ts
                else:
                    sp[3] += e              # te
            else:
                sp[1] += e                  # qe
                if fwd:
                    sp[3] += e              # te
                else:
                    sp[2] -= e              # ts
        return [replace(
            o, query_start_position_in_read=sp[0],
            query_end_position_in_read=sp[1],
            target_start_position_in_read=sp[2],
            target_end_position_in_read=sp[3])
            for o, sp in zip(overlaps, spans)]


def _mesh_overlap_rows(qidx: Index, tidx: Index, cfg: MapperConfig,
                       mesh, cap: int, pack2: bool):
    """Mesh pair step: rep-sharded matching + query-sharded chaining (ONE
    all_to_all routes anchors to the shard owning their query-id range —
    parallel/shard.sharded_match_chain), then the shared compaction.
    Output rows are bit-identical to the single-device path (tests)."""
    from ..parallel.shard import sharded_match_chain
    with trace_range("mapper.match_chain_mesh"):
        out, overflow = sharded_match_chain(
            qidx._arrays, tidx._arrays, cfg, mesh, cap=cap, pack2=pack2,
            n_query_reads=len(qidx.read_lengths),
            first_read=qidx.first_read_id)
    status = (StatusType.EXCEEDED_MAX_ANCHORS if overflow
              else StatusType.SUCCESS)
    return Overlapper.compact_rows(out, mesh=mesh), status


@dataclass
class MapResult:
    overlaps: list[Overlap]
    statuses: list[StatusType]
    cache_hits: int = 0
    cache_misses: int = 0
    #: the same overlaps as an (8, n) int32 array in canonical order —
    #: the scale surface (fuse_overlap_rows etc. avoid object costs)
    rows: np.ndarray | None = None


def map_all_vs_all(parser: FastaParser, cfg: MapperConfig,
                   max_anchors: int | None = None, mesh=None,
                   index_store_dir: str | None = None) -> MapResult:
    """The cudamapper CLI main loop (reference: cudamapper/src/main.cpp [U]):
    chunk reads by the index-size budget, loop (query batch x target batch)
    pairs through Index -> Matcher -> Overlapper, merge deterministically.

    `mesh`: optional Mesh — matching is rep-sharded across its 'rep' axis
    (the reference's one-worker-thread-per-GPU becomes sharded XLA programs);
    output is bit-identical for any mesh size by the canonical merge order.

    `max_anchors`: anchors one index pair may expand to before it reports
    EXCEEDED_MAX_ANCHORS (default core.bufferplan.anchor_capacity())."""
    from ..utils.threadsafe import prefetch_map
    if max_anchors is None:
        max_anchors = anchor_capacity()
    chunks = parser.get_chunks(cfg.index_size_mb * 1_000_000)
    cache = IndexCache(store_dir=index_store_dir)
    all_overlaps: list[Overlap] = []
    statuses: list[StatusType] = []

    def build_pair(pair):
        (qf, ql), (tf, tl) = pair
        return (cache.get_or_create(parser, qf, ql, cfg),
                cache.get_or_create(parser, tf, tl, cfg))

    pairs = ((q, t) for q in chunks for t in chunks)
    # prefetch_map builds the NEXT pair's indices (parser reads + numpy
    # packing + sketch dispatch) on a worker thread while this thread
    # chains and downloads the current pair — the host/device overlap the
    # reference gets from its per-GPU worker threads.  The cache is only
    # touched by the single producer thread.
    all_rows = []
    cap_est: int | None = None     # ratcheting anchor-capacity hint
    nv_est: int | None = None      # ratcheting overlap-count hint
    pending = None                 # previous pair, not yet synced
    pair_iter = prefetch_map(build_pair, pairs, depth=2)

    def materialize(pend):
        # EVERY per-pair blocking sync lives here, one pair behind the
        # dispatches: the truncation check (reads the anchor count the
        # device finished long ago), the capacity/count ratchets, and the
        # row download (usually already on host via the async copy), so
        # no host-device round trip is exposed per pair.
        nonlocal cap_est, nv_est
        matcher, cur, qidx_, tidx_, p2 = pend
        if matcher.truncated:      # rare: redo this pair at exact capacity
            matcher = Matcher.create_matcher(qidx_, tidx_, cfg,
                                             cap=max_anchors)
            cur = Overlapper.get_overlap_rows_dispatch(
                matcher.anchors(), cfg, pack2=p2,
                q_base=qidx_.first_read_id, t_base=tidx_.first_read_id)
        cap_est = max(cap_est or 0,
                      1 << (max(matcher.n_anchors, 1) - 1).bit_length())
        statuses.append(matcher.status)
        rows_ = Overlapper.compact_materialize(cur)
        nv_est = max(nv_est or 128, rows_.shape[1])
        all_rows.append(rows_)

    for qidx, tidx in pair_iter:
        if mesh is not None and mesh.shape.get("rep", 1) > 1:
            if pending is not None:
                materialize(pending)
                pending = None
            rows, st = _mesh_overlap_rows(
                qidx, tidx, cfg, mesh, max_anchors,
                _pack2_ok_global(qidx, tidx))
            statuses.append(st)
            all_rows.append(rows)
            continue
        # pair 0 takes the exact-capacity (synced) path and seeds the
        # ratchets; later pairs dispatch with the hints and defer every
        # blocking read to materialize()
        p2 = _pack2_ok(qidx, tidx)
        matcher = Matcher.create_matcher(qidx, tidx, cfg, cap=max_anchors,
                                         cap_hint=cap_est)
        cur = Overlapper.get_overlap_rows_dispatch(
            matcher.anchors(), cfg, pack2=p2,
            q_base=qidx.first_read_id, t_base=tidx.first_read_id,
            nv_hint=nv_est)
        if pending is not None:
            materialize(pending)
        pending = (matcher, cur, qidx, tidx, p2)
    if pending is not None:
        materialize(pending)
    rows = (np.concatenate(all_rows, axis=1) if all_rows
            else np.zeros((8, 0), np.int32))
    rows = rows[:, _canonical_order(rows)]
    all_overlaps = Overlapper.rows_to_overlaps(rows)
    return MapResult(all_overlaps, statuses, cache.hits, cache.misses,
                     rows=rows)


def map_query_vs_target(query_parser: FastaParser,
                        target_parser: FastaParser, cfg: MapperConfig,
                        max_anchors: int | None = None, mesh=None,
                        target_index_size_mb: int | None = None,
                        index_store_dir: str | None = None) -> MapResult:
    """Two-file mapping: every query read against every target read
    (reference: the cudamapper CLI's query-vs-target mode with separate
    -i/-t index budgets [U]).  `target_index_size_mb` is the -t analog
    (defaults to the query budget).  Self-mapping suppression is OFF:
    query and target are distinct files, so equal numeric read ids are
    unrelated reads."""
    if max_anchors is None:
        max_anchors = anchor_capacity()
    qchunks = query_parser.get_chunks(cfg.index_size_mb * 1_000_000)
    t_mb = (target_index_size_mb if target_index_size_mb is not None
            else cfg.index_size_mb)
    tchunks = target_parser.get_chunks(t_mb * 1_000_000)
    cfg = replace(cfg, skip_self_mappings=False)
    cache = IndexCache(store_dir=index_store_dir)
    statuses: list[StatusType] = []
    all_rows = []
    cap_est: int | None = None     # ratcheting hints (see map_all_vs_all)
    nv_est: int | None = None
    pending = None                 # one-behind pair (see map_all_vs_all)

    def materialize(pend):
        nonlocal cap_est, nv_est
        matcher, cur, qidx_, tidx_, p2 = pend
        if matcher.truncated:
            matcher = Matcher.create_matcher(qidx_, tidx_, cfg,
                                             cap=max_anchors)
            cur = Overlapper.get_overlap_rows_dispatch(
                matcher.anchors(), cfg, pack2=p2,
                q_base=qidx_.first_read_id, t_base=tidx_.first_read_id)
        cap_est = max(cap_est or 0,
                      1 << (max(matcher.n_anchors, 1) - 1).bit_length())
        statuses.append(matcher.status)
        rows_ = Overlapper.compact_materialize(cur)
        nv_est = max(nv_est or 128, rows_.shape[1])
        all_rows.append(rows_)

    for (qf, ql) in qchunks:
        qidx = cache.get_or_create(query_parser, qf, ql, cfg)
        for (tf, tl) in tchunks:
            tidx = cache.get_or_create(target_parser, tf, tl, cfg)
            if mesh is not None and mesh.shape.get("rep", 1) > 1:
                if pending is not None:
                    materialize(pending)
                    pending = None
                rows, st = _mesh_overlap_rows(
                    qidx, tidx, cfg, mesh, max_anchors,
                    _pack2_ok_global(qidx, tidx))
                statuses.append(st)
                all_rows.append(rows)
                continue
            p2 = _pack2_ok(qidx, tidx)
            matcher = Matcher.create_matcher(qidx, tidx, cfg,
                                             cap=max_anchors,
                                             cap_hint=cap_est)
            cur = Overlapper.get_overlap_rows_dispatch(
                matcher.anchors(), cfg, pack2=p2,
                q_base=qidx.first_read_id, t_base=tidx.first_read_id,
                nv_hint=nv_est)
            if pending is not None:
                materialize(pending)
            pending = (matcher, cur, qidx, tidx, p2)
    if pending is not None:
        materialize(pending)
    rows = (np.concatenate(all_rows, axis=1) if all_rows
            else np.zeros((8, 0), np.int32))
    rows = rows[:, _canonical_order(rows)]
    all_overlaps = Overlapper.rows_to_overlaps(rows)
    return MapResult(all_overlaps, statuses, cache.hits, cache.misses,
                     rows=rows)


def overlaps_to_paf(overlaps: list[Overlap], parser: FastaParser,
                    target_parser: FastaParser | None = None) -> list[str]:
    """PAF rows; `target_parser` resolves target read names/lengths when
    the overlaps came from a two-file (query-vs-target) run."""
    tp = target_parser if target_parser is not None else parser
    rows = []
    for o in overlaps:
        q = parser.get_sequence_by_id(o.query_read_id)
        t = tp.get_sequence_by_id(o.target_read_id)
        rows.append(format_paf_row(o, q.name, len(q.seq), t.name, len(t.seq)))
    return rows
