"""Ring-wavefront sequence-parallel NW — the 'sp' mesh axis (SURVEY.md §5.7).

The reference has NO cross-device story for one problem (its long-sequence
axis is handled algorithmically: banding + Hirschberg).  This is the
extension: when one pair is too long for a single device, the DP matrix's
*target* axis is sharded over the
'sp' mesh axis and the wavefront is pipelined systolically:

- device d owns target columns [d*S, (d+1)*S) (t is sharded over 'sp');
- at pipeline step T, device d computes DP row i = T - d + 1 over its stripe
  (a software-pipelined wavefront: all devices busy after `sp` fill steps);
- the only cross-device data is the O(1) frontier — each step, device d
  passes (D[i-1, edge], D[i, edge]) of its LAST column to device d+1 via
  `jax.lax.ppermute` (the ring), which is exactly the seed its neighbour
  needs for the diagonal term and the in-row min-plus gap chain.

This is the DP analog of ring attention: stationary stripes, rotating
frontier.  Dependencies in (row, column) coordinates all point down/right,
so the schedule T(i, d) = i + d - 1 gives 100% pipeline utilization after
fill (contrast: sharding the *band-offset* axis would make the insertion
term point right-to-left and halve utilization).

Semantics: unit-cost global edit distance, bit-identical to
cpu/nw_oracle.nw_matrix[qlen, tlen] (asserted by tests on the 8-fake-device
CPU mesh).  Score-only by design — the linear-memory traceback for such
lengths is Hirschberg (align/hirschberg.py) driven over this kernel's
forward/reverse score rows.

Composes with the 'data' axis: the batch dim is sharded over 'data', the
target axis over 'sp'.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.mathutils import round_up


@functools.partial(jax.jit, static_argnames=("mesh",))
def _ring_nw(q, qlen, t, tlen, mesh: Mesh):
    sp = mesh.shape["sp"]
    Lq = q.shape[1]
    Lt = t.shape[1]
    S = Lt // sp
    n_steps = Lq + sp - 1

    def local(q, qlen, t, tlen):
        # q: (Bl, Lq) replicated over sp; t: (Bl, S) this device's stripe
        d = jax.lax.axis_index("sp")
        Bl = q.shape[0]
        c0 = d * S                                   # global col of stripe[0]
        xx = jnp.arange(1, S + 1, dtype=jnp.int32)   # local 1-based offsets
        row0 = (c0 + xx)[None, :] * jnp.ones((Bl, 1), jnp.int32)  # D[0, :]
        tcol = tlen - c0 - 1                         # local idx of column tlen
        owns_t = (tcol >= 0) & (tcol < S)
        tcol_c = jnp.clip(tcol, 0, S - 1)[:, None]

        def step(carry, T):
            row_im1, msg, score = carry
            i = T - d + 1
            active = (i >= 1) & (i <= Lq)
            # frontier from the left neighbour (ring); device 0 synthesizes
            # the true column-0 boundary D[i-1,0]=i-1, D[i,0]=i
            in_msg = jax.lax.ppermute(
                msg, "sp", perm=[(s, (s + 1) % sp) for s in range(sp)])
            boundary = jnp.stack(
                [jnp.full((Bl,), i - 1, jnp.int32),
                 jnp.full((Bl,), i, jnp.int32)], axis=1)
            in_msg = jnp.where(d == 0, boundary, in_msg)
            in_prev, in_cur = in_msg[:, 0], in_msg[:, 1]

            qch = jax.lax.dynamic_slice_in_dim(
                q, jnp.clip(i - 1, 0, Lq - 1), 1, axis=1)      # (Bl, 1)
            sub = jnp.where((qch == t) & (qch >= 0), 0, 1).astype(jnp.int32)
            diag = jnp.concatenate([in_prev[:, None], row_im1[:, :-1]], axis=1)
            vals = jnp.minimum(diag + sub, row_im1 + 1)
            # in-row deletion chain: row[x] = x + cummin(seed, vals[l] - l)
            seeded = jnp.concatenate([in_cur[:, None], vals - xx[None, :]],
                                     axis=1)
            row_i = jax.lax.cummin(seeded, axis=1)[:, 1:] + xx[None, :]

            hit = active & owns_t & (i == qlen) & (qlen >= 1) & (tlen >= 1)
            captured = jnp.take_along_axis(row_i, tcol_c, axis=1)[:, 0]
            score = jnp.where(hit, captured, score)

            out_msg = jnp.stack([row_im1[:, -1], row_i[:, -1]], axis=1)
            msg = jnp.where(active, out_msg, msg)
            row_im1 = jnp.where(active, row_i, row_im1)
            return (row_im1, msg, score), ()

        # seed the carry with input-derived zeros so its varying-manual-axes
        # match the loop body's ('data' from q/t, 'sp' from axis_index)
        z = (t[:, :1] * 0) + (q[:, :1] * 0)          # (Bl, 1) zeros, vma-full
        carry0 = (row0 + z, z * jnp.ones((1, 2), jnp.int32),
                  z[:, 0])
        (_, _, score), _ = jax.lax.scan(
            step, carry0, jnp.arange(n_steps, dtype=jnp.int32))
        # exactly one device captured each problem's score
        score = jax.lax.psum(jnp.where(owns_t, score, 0), "sp")
        return jnp.where(qlen == 0, tlen, jnp.where(tlen == 0, qlen, score))

    return shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("data", "sp"), P("data")),
        out_specs=P("data"),
    )(q, qlen, t, tlen)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _ring_nw_rows(q, qlen, t, tlen, mesh: Mesh):
    """Like _ring_nw but returns the BOTTOM ROW D[qlen, 1..Lt] (sharded
    over 'sp', gathered by the out_spec) — the quantity Hirschberg's split
    step needs.  Unit-cost distances, bit-identical to
    cpu/nw_oracle.nw_matrix[qlen, 1:]."""
    sp = mesh.shape["sp"]
    Lq = q.shape[1]
    Lt = t.shape[1]
    S = Lt // sp
    n_steps = Lq + sp - 1

    def local(q, qlen, t, tlen):
        d = jax.lax.axis_index("sp")
        Bl = q.shape[0]
        c0 = d * S
        xx = jnp.arange(1, S + 1, dtype=jnp.int32)
        row0 = (c0 + xx)[None, :] * jnp.ones((Bl, 1), jnp.int32)

        def step(carry, T):
            row_im1, msg, row_cap = carry
            i = T - d + 1
            active = (i >= 1) & (i <= Lq)
            in_msg = jax.lax.ppermute(
                msg, "sp", perm=[(s, (s + 1) % sp) for s in range(sp)])
            boundary = jnp.stack(
                [jnp.full((Bl,), i - 1, jnp.int32),
                 jnp.full((Bl,), i, jnp.int32)], axis=1)
            in_msg = jnp.where(d == 0, boundary, in_msg)
            in_prev, in_cur = in_msg[:, 0], in_msg[:, 1]

            qch = jax.lax.dynamic_slice_in_dim(
                q, jnp.clip(i - 1, 0, Lq - 1), 1, axis=1)
            sub = jnp.where((qch == t) & (qch >= 0), 0, 1).astype(jnp.int32)
            diag = jnp.concatenate([in_prev[:, None], row_im1[:, :-1]],
                                   axis=1)
            vals = jnp.minimum(diag + sub, row_im1 + 1)
            seeded = jnp.concatenate([in_cur[:, None], vals - xx[None, :]],
                                     axis=1)
            row_i = jax.lax.cummin(seeded, axis=1)[:, 1:] + xx[None, :]

            hit = (active & (i == qlen))[:, None]
            row_cap = jnp.where(hit, row_i, row_cap)

            out_msg = jnp.stack([row_im1[:, -1], row_i[:, -1]], axis=1)
            msg = jnp.where(active, out_msg, msg)
            row_im1 = jnp.where(active, row_i, row_im1)
            return (row_im1, msg, row_cap), ()

        z = (t[:, :1] * 0) + (q[:, :1] * 0)
        # row_cap seeds with D[0, :] so qlen == 0 yields the correct row j
        carry0 = (row0 + z, z * jnp.ones((1, 2), jnp.int32), row0 + z)
        (_, _, row_cap), _ = jax.lax.scan(
            step, carry0, jnp.arange(n_steps, dtype=jnp.int32))
        return row_cap

    return shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("data", "sp"), P("data")),
        out_specs=P("data", "sp"),
    )(q, qlen, t, tlen)


def ring_wavefront_nw_rows(q, qlen, t, tlen, mesh: Mesh):
    """Bottom edit-distance row D[qlen, 0..Lt] with the target axis sharded
    over 'sp' (Hirschberg's split input for pairs too long for one chip's
    stripe).  Returns (B, Lt+1) int32 (column 0 = qlen boundary)."""
    n_data, sp = mesh.shape["data"], mesh.shape["sp"]
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    B = q.shape[0]
    Lt = t.shape[1]
    Bp = round_up(max(B, n_data), n_data)
    Ltp = round_up(max(Lt, sp), sp)
    q = np.pad(q, ((0, Bp - B), (0, 0)), constant_values=-1)
    t = np.pad(t, ((0, Bp - B), (0, Ltp - Lt)), constant_values=-1)
    qlen_p = np.pad(np.asarray(qlen, np.int32), (0, Bp - B))
    tlen_p = np.pad(np.asarray(tlen, np.int32), (0, Bp - B))
    td = jax.device_put(t, NamedSharding(mesh, P("data", "sp")))
    qd = jax.device_put(q, NamedSharding(mesh, P("data", None)))
    rows = np.asarray(_ring_nw_rows(qd, jnp.asarray(qlen_p), td,
                                    jnp.asarray(tlen_p), mesh))[:B, :Lt]
    return np.concatenate(
        [np.asarray(qlen, np.int32).reshape(B, 1), rows], axis=1)


def ring_wavefront_nw(q, qlen, t, tlen, mesh: Mesh):
    """Global edit distance with the target axis sharded over mesh axis 'sp'
    and the batch over 'data'.  Returns (B,) int32 scores equal to the full
    NW distance (cpu/nw_oracle).  Pads internally: batch to a multiple of
    the 'data' size, target length to a multiple of the 'sp' size."""
    n_data, sp = mesh.shape["data"], mesh.shape["sp"]
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    B = q.shape[0]
    Bp = round_up(max(B, n_data), n_data)
    Ltp = round_up(max(t.shape[1], sp), sp)
    q = np.pad(q, ((0, Bp - B), (0, 0)), constant_values=-1)
    t = np.pad(t, ((0, Bp - B), (0, Ltp - t.shape[1])), constant_values=-1)
    qlen = np.pad(np.asarray(qlen, np.int32), (0, Bp - B))
    tlen = np.pad(np.asarray(tlen, np.int32), (0, Bp - B))
    sh = NamedSharding(mesh, P("data", "sp"))
    td = jax.device_put(t, sh)
    qd = jax.device_put(q, NamedSharding(mesh, P("data", None)))
    scores = _ring_nw(qd, jnp.asarray(qlen), td, jnp.asarray(tlen), mesh)
    return np.asarray(scores)[:B]
