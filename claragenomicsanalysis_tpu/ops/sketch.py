"""Minimizer sketching on device (reference: cudamapper/src/minimizer.cu [U]).

The CUDA version assigns thread blocks per read and walks windows; this
version computes, for the whole (B, L) read batch at once:

- packed forward / reverse-complement k-mer reps via k static shifted slices;
- central minimizers via the closed form  rep[p] == max over the w window
  minima that contain p  (max == exists, since every containing window's min
  is <= rep[p]);
- prefix/suffix end-minimizers via running minima (lax cummin), which are
  exact because positions past each read's end hold the INVALID sentinel.

Semantics defined (and tested bit-identical) against cpu/mapper_oracle.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

INVALID = jnp.uint32(0xFFFFFFFF)


def murmur32(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def pack_reads(reads: np.ndarray, lens: np.ndarray):
    """Host-side 2-bit packing of an encoded (B, L) int8 read matrix for
    the host-to-device transfer (a quarter of the byte-per-base matrix).
    Returns (packed (B, L//4) uint8, n_rows, n_cols): the index lists mark
    ambiguous (N, code -1) bases INSIDE each read's span — tail padding
    needs no sentinel because _sketch_core's `pos < n` mask already
    invalidates every k-mer touching it (bases are clipped to [0, 3] in
    the packed words exactly like the unpacked path's maximum(c, 0)).
    L must be a multiple of 4.

    Routes to the native one-pass packer (native/pack2.cpp) when built —
    the NumPy path makes ~7 array passes — with this NumPy fallback kept
    bit-identical."""
    B, L = reads.shape
    assert L % 4 == 0, L
    try:
        from ..io.native_pack import pack2
        return pack2(reads, lens)
    except ImportError:
        pass
    r = np.clip(reads, 0, 3).astype(np.uint8).reshape(B, L // 4, 4)
    packed = (r[:, :, 0] | (r[:, :, 1] << 2) | (r[:, :, 2] << 4)
              | (r[:, :, 3] << 6))
    nn = np.argwhere((reads < 0)
                     & (np.arange(L)[None, :] < np.asarray(lens)[:, None]))
    return packed, nn[:, 0].astype(np.int32), nn[:, 1].astype(np.int32)


@functools.partial(jax.jit, static_argnames=("k", "w", "hash_reps"))
def sketch_batch_packed(packed: jnp.ndarray, n_rows, n_cols,
                        lens: jnp.ndarray, k: int, w: int,
                        hash_reps: bool = True):
    """sketch_batch on a 2-bit-packed read matrix (see pack_reads) —
    bit-identical outputs; the unpack fuses into the packing loop's first
    pass.  n_rows/n_cols restore the -1 sentinel at N/pad positions that
    pack_reads clipped (out-of-range rows in the padded index lists drop)."""
    B, L4 = packed.shape
    L = L4 * 4
    up = jnp.repeat(packed.astype(jnp.uint32), 4, axis=1)
    sh = (jnp.arange(L, dtype=jnp.int32) % 4) * 2
    codes = ((up >> sh[None, :].astype(jnp.uint32)) & 3).astype(jnp.int8)
    codes = codes.at[n_rows, n_cols].set(-1, mode="drop")
    return _sketch_core(codes, lens, k, w, hash_reps)


@functools.partial(jax.jit, static_argnames=("k", "w", "hash_reps"))
def sketch_batch(reads: jnp.ndarray, lens: jnp.ndarray, k: int, w: int,
                 hash_reps: bool = True):
    """Returns (rep (B, Lk) uint32 with INVALID at non-kmers, dirs (B, Lk)
    int32, is_min (B, Lk) bool).  Lk = L - k + 1."""
    return _sketch_core(reads, lens, k, w, hash_reps)


def _sketch_core(reads: jnp.ndarray, lens: jnp.ndarray, k: int, w: int,
                 hash_reps: bool = True):
    B, L = reads.shape
    Lk = L - k + 1
    assert Lk >= 1, "reads shorter than k"
    codes = reads.astype(jnp.int32)
    lens = lens.astype(jnp.int32)

    # two-word packing: a 2k-bit k-mer in (hi, lo) uint32 pairs — 2-bit
    # fields sit at even bit offsets, so none straddles the word boundary.
    # k <= 15 keeps hi == 0 and reproduces the single-word representation.
    f_lo = jnp.zeros((B, Lk), jnp.uint32)
    f_hi = jnp.zeros((B, Lk), jnp.uint32)
    r_lo = jnp.zeros((B, Lk), jnp.uint32)
    r_hi = jnp.zeros((B, Lk), jnp.uint32)
    valid = jnp.ones((B, Lk), bool)
    for i in range(k):
        c = jax.lax.dynamic_slice_in_dim(codes, i, Lk, axis=1)
        valid &= c >= 0
        cpos = jnp.maximum(c, 0).astype(jnp.uint32)
        bf = 2 * (k - 1 - i)
        if bf <= 30:
            f_lo |= cpos << bf
        else:
            f_hi |= cpos << (bf - 32)
        br = 2 * i
        if br <= 30:
            r_lo |= (3 - cpos) << br
        else:
            r_hi |= (3 - cpos) << (br - 32)

    pos = jnp.arange(Lk, dtype=jnp.int32)[None, :]
    n = (lens - k + 1)[:, None]                   # kmers per read
    valid &= pos < n

    f_gt_r = (f_hi > r_hi) | ((f_hi == r_hi) & (f_lo > r_lo))
    c_lo = jnp.where(f_gt_r, r_lo, f_lo)
    c_hi = jnp.where(f_gt_r, r_hi, f_hi)
    dirs = f_gt_r.astype(jnp.int32)
    # canonical hash rule (cpu/mapper_oracle.py): murmur32(0) == 0, so for
    # k <= 15 this equals the single-word murmur32(c)
    rep = murmur32(c_lo ^ murmur32(c_hi)) if hash_reps else c_lo
    rep = jnp.where(valid, rep, INVALID)

    # central minimizers
    if Lk >= w:
        wm = rep
        for s in range(1, w):                     # window minima (start at i)
            shifted = jnp.concatenate(
                [rep[:, s:], jnp.full((B, s), INVALID)], axis=1)
            wm = jnp.minimum(wm, shifted)
        # wm[i] valid iff 0 <= i <= n - w
        wm_ok = pos <= n - w
        wm_m = jnp.where(wm_ok, wm, 0)            # identity for unsigned max
        cmax = wm_m
        for s in range(1, w):                     # max over i in [p-w+1, p]
            shifted = jnp.concatenate(
                [jnp.zeros((B, s), jnp.uint32), wm_m[:, :-s]], axis=1)
            cmax = jnp.maximum(cmax, shifted)
        central = (rep == cmax) & (n >= w)
    else:
        central = jnp.zeros((B, Lk), bool)

    cmin = jax.lax.cummin(rep, axis=1)
    rmin = jax.lax.cummin(rep[:, ::-1], axis=1)[:, ::-1]
    pre = (rep == cmin) & (pos <= w - 2)
    suf = (rep == rmin) & (pos >= n - w + 1)

    is_min = valid & (central | pre | suf)
    return rep, dirs, is_min
