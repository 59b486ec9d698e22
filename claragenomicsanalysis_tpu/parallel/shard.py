"""Sharded execution of the three module families over a mesh.

Data-parallel paths annotate the leading batch dim with NamedSharding and
let XLA partition the (already batched) programs — merging is concatenation,
so N-device output == 1-device output bit-for-bit (asserted by tests on the
8-fake-device CPU mesh).

The matcher is the interesting one: the target index is sharded by sorted
representation BLOCKS over the 'rep' axis (contiguous slices of the sorted
element arrays — block boundaries may split a representation run, which is
harmless: each shard emits its part of the cross product and the union is
exactly the full anchor set).  Queries are replicated.  Each shard's anchors
then travel to the shard owning their QUERY-READ range with one
lax.all_to_all (SURVEY.md §2.7's Ulysses-style exchange), so the triggered
chain — whose anchor sort is the mapper's dominant device stage — runs on
~1/N of the anchors per shard instead of being replicated over an
all-gathered copy.  Chains cannot straddle shards (a chain lives inside one
(q_read, t_read, dir) group and routing is by q_read); capacities come from
a counting pre-pass, mirroring the engine's adaptive pow2-capacity
discipline.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import map_ops, nw_band
from ..utils.mathutils import round_up


def _dp_sharding(mesh: Mesh):
    return NamedSharding(mesh, P(("data",)))


def sharded_banded_nw(q, qlen, t, tlen, band_radius: int, mesh: Mesh):
    """Data-parallel banded NW: batch dim split over 'data'.  On a
    process-spanning mesh, host inputs (identical everywhere) become
    global arrays and outputs re-replicate so every host can read them."""
    n_data = mesh.shape["data"]
    B = q.shape[0]
    Bp = round_up(B, n_data)
    pad = Bp - B

    def padb(x, fill):
        return np.concatenate(
            [np.asarray(x),
             np.full((pad,) + np.asarray(x).shape[1:], fill,
                     np.asarray(x).dtype)]) if pad else np.asarray(x)

    sh = _dp_sharding(mesh)
    args = [padb(q, -1), padb(qlen, 0), padb(t, -1), padb(tlen, 0)]
    if jax.process_count() > 1:
        args = [jax.make_array_from_callback(
            a.shape, sh, lambda idx, _a=a: _a[idx]) for a in args]
        repl = NamedSharding(mesh, P())
        scores, tb = jax.jit(
            functools.partial(nw_band.banded_nw, band_radius=band_radius),
            out_shardings=repl)(*args)
    else:
        args = [jax.device_put(a, sh) for a in args]
        scores, tb = nw_band.banded_nw(*args, band_radius)
    return scores[:B], tb[:, :B]


def sharded_poa(program, seqs, weights, lens, n_seqs, mesh: Mesh):
    """Data-parallel POA: window dim split over 'data' via shard_map —
    each device runs `program` (the XLA window program of
    models.poa._build_program) on its local window slice.  Merging is
    concatenation, so N-device == 1-device bit-for-bit.

    When the mesh spans PROCESSES (multi-host correction, SURVEY §5.8),
    host inputs — identical on every host by construction — become global
    arrays and outputs are re-replicated so each host materializes the
    full result."""
    n_data = mesh.shape["data"]
    W = seqs.shape[0]
    Wp = round_up(W, n_data)
    pad = Wp - W

    def padw(x, fill):
        x = np.asarray(x)
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]) if pad else x

    args = [padw(seqs, -1), padw(weights, 0), padw(lens, 0), padw(n_seqs, 0)]
    multi = jax.process_count() > 1
    sm = shard_map(
        program, mesh=mesh,
        in_specs=(P(("data",)), P(("data",)), P(("data",)), P(("data",))),
        out_specs=P(("data",)),
        check_vma=False)  # windows are independent; outputs shard cleanly
    if multi:
        in_sh = NamedSharding(mesh, P(("data",)))
        args = [jax.make_array_from_callback(
            a.shape, in_sh, lambda idx, _a=a: _a[idx]) for a in args]
        fn = jax.jit(sm, out_shardings=NamedSharding(mesh, P()))
    else:
        fn = jax.jit(sm)
    out = fn(*args)
    return tuple(np.asarray(o)[:W] for o in out)


@functools.partial(jax.jit, static_argnames=("cap", "skip_self", "mesh"))
def _sharded_match(qidx, tidx, cap: int, skip_self: bool, mesh: Mesh):
    n_rep = mesh.shape["rep"]
    cap_local = cap // n_rep

    def local_match(q_arrays, t_arrays):
        # q replicated, t sharded by sorted-rep blocks (leading dim split)
        anchors, total, overflow = map_ops.match_anchors(
            q_arrays, t_arrays, cap=cap_local, skip_self=skip_self)
        # gather every shard's anchors along a new leading axis
        gathered = jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, "rep", axis=0), anchors)
        total = jax.lax.psum(total, "rep")
        overflow = jax.lax.psum(overflow.astype(jnp.int32), "rep") > 0
        return gathered, total, overflow

    q_spec = {k: P() for k in qidx}
    t_spec = {k: P() if k in ("n_elems", "first_read") else P(("rep",))
              for k in tidx}
    anchors, total, overflow = shard_map(
        local_match, mesh=mesh,
        in_specs=(q_spec, t_spec),
        out_specs=({k: P() for k in ["q_read", "t_read", "q_pos", "t_pos",
                                     "dir", "valid"]}, P(), P()),
        check_vma=False,  # outputs are replicated by construction (all_gather/psum)
    )(qidx, tidx)
    # flatten shard axis back to one anchor list
    anchors = {k: v.reshape(-1) for k, v in anchors.items()}
    return anchors, total, overflow


def sharded_anchors(qidx_arrays: dict, tidx_arrays: dict, cfg, mesh: Mesh,
                    cap: int = 1 << 18):
    """Rep-sharded anchor generation: target index split into sorted-rep
    blocks over the 'rep' axis, anchors all-gathered back.  Returns
    (anchors dict, total, overflow) like ops.map_ops.match_anchors.

    `cap` is the PER-SHARD anchor capacity (shard loads are skewed by the
    rep distribution, so each shard gets the full cap rather than cap/N)."""
    n_rep = mesh.shape["rep"]
    qj = {k: jnp.asarray(v) for k, v in qidx_arrays.items()}
    tj = _pad_target_for_rep(tidx_arrays, n_rep)
    return _sharded_match(
        qj, tj, cap=round_up(cap, n_rep) * n_rep,
        skip_self=cfg.skip_self_mappings, mesh=mesh)


def _chain_kwargs(cfg) -> dict:
    from fractions import Fraction
    frac = Fraction(cfg.min_overlap_fraction).limit_denominator(10**6)
    return dict(k=cfg.kmer_size, min_residues=cfg.min_residues,
                min_overlap_len=cfg.min_overlap_len,
                min_bases_per_residue=cfg.min_bases_per_residue,
                min_overlap_fraction_num=frac.numerator,
                min_overlap_fraction_den=frac.denominator,
                max_gap=cfg.max_anchor_gap)


def _pad_target_for_rep(tidx_arrays: dict, n_rep: int) -> dict:
    """Pad the sorted target element arrays to a multiple of n_rep (pad
    elements carry rep=INVALID at the tail, so no query rep ever selects
    them) so the leading dim splits evenly over the 'rep' axis.  Device
    ops only: the index arrays are deliberately device-resident and must
    not round-trip the host per chunk pair."""
    Ct = tidx_arrays["rep"].shape[0]
    Ctp = round_up(Ct, n_rep)
    tpad = {}
    for k, v in tidx_arrays.items():
        v = jnp.asarray(v)
        if k in ("n_elems", "first_read"):
            tpad[k] = v
            continue
        fill = (jnp.array(0xFFFFFFFF, v.dtype) if k == "rep"
                else jnp.zeros((), v.dtype))
        tpad[k] = jnp.concatenate([v, jnp.full(Ctp - Ct, fill, v.dtype)])
    return tpad


@functools.partial(jax.jit, static_argnames=("mesh",))
def _routed_sizes(qidx, tidx, qid0, n_reads, mesh: Mesh):
    """Counting pre-pass (no anchor expansion): per-shard anchor totals and
    per-(shard, dest) routing-bucket counts, so the routed pass below can
    compile at the TRUE pow2 capacities — the mesh analog of the engine's
    match_count -> sync -> match_expand adaptive-capacity discipline.
    Counts ignore skip_self (applied at expansion), so they are safe upper
    bounds.  Also returns each shard's (lo, cum) sharded over 'rep' so the
    routed pass reuses them instead of re-running match_count."""
    n_rep = mesh.shape["rep"]

    def body(q_arrays, t_arrays, qid0, n_reads):
        lo, cum, total = map_ops.match_count(q_arrays, t_arrays)
        cnt = cum[1:] - cum[:-1]                       # per query element
        dest = jnp.clip((q_arrays["read_id"] - qid0) * n_rep // n_reads,
                        0, n_rep - 1)
        # n_rep masked sums (a scatter-add with millions of duplicate
        # indices serializes; n_rep is tiny)
        buckets = jnp.stack([jnp.sum(jnp.where(dest == d, cnt, 0))
                             for d in range(n_rep)])
        return (jax.lax.all_gather(buckets, "rep", axis=0),
                jax.lax.all_gather(total, "rep", axis=0),
                lo[None], cum[None])

    q_spec = {k: P() for k in qidx}
    t_spec = {k: P() if k in ("n_elems", "first_read") else P(("rep",))
              for k in tidx}
    return shard_map(body, mesh=mesh, in_specs=(q_spec, t_spec, P(), P()),
                     out_specs=(P(), P(), P(("rep",)), P(("rep",))),
                     check_vma=False)(qidx, tidx, qid0, n_reads)


@functools.partial(
    jax.jit, static_argnames=("cap_local", "c_send", "skip_self", "pack2",
                              "mesh", "chain_statics"))
def _routed_match_chain(qidx, tidx, lo, cum, qid0, n_reads, cap_local: int,
                        c_send: int, skip_self: bool, pack2: bool,
                        mesh: Mesh, chain_statics: tuple):
    """shard_map body: rep-sharded matching (reusing the pre-pass's lo/cum),
    ONE all_to_all routing anchors to the shard owning their query-read
    range, then a LOCAL triggered chain per shard (see
    sharded_match_chain)."""
    n_rep = mesh.shape["rep"]
    chain_kw = dict(chain_statics)

    def body(q_arrays, t_arrays, lo, cum, qid0, n_reads):
        lo, cum = lo[0], cum[0]
        total = cum[-1]
        overflow = total > cap_local
        anchors = map_ops.match_expand(q_arrays, t_arrays, lo, cum,
                                       cap=cap_local, skip_self=skip_self)
        # ---- route anchors to the shard owning their query-id range
        v = anchors["valid"]
        dest = jnp.clip((anchors["q_read"] - qid0) * n_rep // n_reads,
                        0, n_rep - 1)
        dest = jnp.where(v, dest, n_rep)       # park invalid rows at the end
        iota = jnp.arange(dest.shape[0], dtype=jnp.int32)
        sd, perm = jax.lax.sort((dest, iota), num_keys=1, is_stable=True)
        # bucket bounds from the SORTED dest (a bincount here would
        # scatter-add millions of duplicate indices into n_rep bins, which
        # serializes)
        bins = jnp.arange(n_rep, dtype=jnp.int32)
        offs0 = jnp.searchsorted(sd, bins, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(sd, bins, side="right").astype(jnp.int32)
        counts = ends - offs0
        j = jnp.arange(c_send, dtype=jnp.int32)
        idx = offs0[:, None] + j[None, :]             # (n_rep, c_send)
        in_bucket = j[None, :] < counts[:, None]
        src = perm[jnp.clip(idx, 0, dest.shape[0] - 1)]
        overflow |= jnp.any(counts > c_send)          # dropped rows -> retry

        def exchange(x, fill):
            g = jnp.where(in_bucket, x[src], fill)
            return jax.lax.all_to_all(g, "rep", split_axis=0,
                                      concat_axis=0, tiled=True).reshape(-1)

        routed = {k: exchange(anchors[k], 0)
                  for k in ("q_read", "t_read", "q_pos", "t_pos", "dir")}
        routed["valid"] = exchange(v.astype(jnp.int8), 0).astype(bool)

        # ---- local chain: only this shard's query ids (chains can't
        # straddle shards — a chain lives inside one (q,t,dir) group)
        out = map_ops.chain_anchors(routed, pack2=pack2, **chain_kw)
        total = jax.lax.psum(total, "rep")
        overflow = jax.lax.psum(overflow.astype(jnp.int32), "rep") > 0
        return out, total, overflow

    q_spec = {k: P() for k in qidx}
    t_spec = {k: P() if k in ("n_elems", "first_read") else P(("rep",))
              for k in tidx}
    out_fields = list(map_ops.OVERLAP_FIELDS) + ["valid"]
    return shard_map(
        body, mesh=mesh,
        in_specs=(q_spec, t_spec, P(("rep",)), P(("rep",)), P(), P()),
        out_specs=({k: P(("rep",)) for k in out_fields}, P(), P()),
        check_vma=False,  # totals/overflow replicated by psum
    )(qidx, tidx, lo, cum, qid0, n_reads)


def sharded_match_chain(qidx_arrays: dict, tidx_arrays: dict, cfg, mesh: Mesh,
                        cap: int = 1 << 18, pack2: bool = False,
                        route: bool = True,
                        n_query_reads: int | None = None,
                        first_read: int | None = None):
    """Rep-sharded matching + QUERY-sharded chaining over the 'rep' axis.

    route=True (default): after per-shard anchor expansion, anchors travel
    to the shard owning their query-read range with ONE lax.all_to_all (the
    Ulysses-style exchange of SURVEY §2.7) and each shard runs the
    triggered chain on ONLY its queries — the chain's dominant sort runs on
    ~2*cap/N rows per shard instead of being replicated over N*cap
    all-gathered rows.  Chains cannot straddle shards (a chain lives inside
    one (q_read, t_read, dir) group and routing is by q_read), and the
    merged masked output compacts to the same canonical overlap set
    bit-for-bit (asserted vs the 1-device path by tests/test_parallel.py).

    route=False keeps the round-1 formulation (anchors all-gathered,
    chain replicated) for comparison.

    Returns (masked overlap dict as ops.map_ops.chain_anchors — device
    resident, fields shaped (n_rep * c_send,) — and an overflow bool).
    Capacities come from a cheap counting pre-pass synced to the host
    (exact upper bounds, pow2-bucketed), so overflow only fires when the
    true anchor count exceeds the caller's `cap` — the same
    EXCEEDED_MAX_ANCHORS contract as the single-device path."""
    n_rep = mesh.shape["rep"]
    if not route:
        anchors, total, overflow = sharded_anchors(
            qidx_arrays, tidx_arrays, cfg, mesh, cap=cap // n_rep)
        out = map_ops.chain_anchors(anchors, pack2=False,
                                    **_chain_kwargs(cfg))
        return {k: np.asarray(v) for k, v in out.items()}, bool(overflow)

    # index arrays stay device-resident (jnp.asarray is a no-op for them);
    # only the tiny size scalars below sync to the host
    qj = {k: jnp.asarray(v) for k, v in qidx_arrays.items()}
    tj = _pad_target_for_rep(tidx_arrays, n_rep)
    if first_read is None:
        if "first_read" in qidx_arrays:            # packed index carries it
            first_read = int(np.asarray(qidx_arrays["first_read"]))
        else:                                      # unpacked: derive (1 sync)
            ne = int(np.asarray(qidx_arrays["n_elems"]))
            rid = np.asarray(qidx_arrays["read_id"])[:ne]
            first_read = int(rid.min()) if ne else 0
            if n_query_reads is None:
                n_query_reads = (int(rid.max()) + 1 - first_read) if ne else 1
    qid0 = first_read
    if n_query_reads is None:
        ne = int(np.asarray(qidx_arrays["n_elems"]))
        rid = np.asarray(qidx_arrays["read_id"])[:ne]
        n_query_reads = max(int(rid.max()) + 1 - qid0, 1) if ne else 1
    n_query_reads = max(n_query_reads, 1)
    chain_statics = tuple(sorted(_chain_kwargs(cfg).items()))

    buckets, totals, lo, cum = _routed_sizes(qj, tj, jnp.int32(qid0),
                                             jnp.int32(n_query_reads), mesh)
    max_local = int(np.max(np.asarray(totals)))
    max_bucket = int(np.max(np.asarray(buckets)))
    overflow_cap = int(np.sum(np.asarray(totals))) > cap
    pw2 = lambda x: 1 << (max(int(x), 1) - 1).bit_length()  # noqa: E731
    cap_local = min(max(1024, pw2(max_local)), max(1024, pw2(cap)))
    c_send = min(max(1024, pw2(max_bucket)), cap_local)

    out, total, overflow = _routed_match_chain(
        qj, tj, lo, cum, jnp.int32(qid0), jnp.int32(n_query_reads),
        cap_local=cap_local, c_send=c_send,
        skip_self=cfg.skip_self_mappings, pack2=pack2, mesh=mesh,
        chain_statics=chain_statics)
    return out, bool(overflow) or overflow_cap
