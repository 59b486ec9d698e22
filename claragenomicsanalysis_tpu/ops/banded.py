"""Kernel selection for the two DP operations, in one place.

Banded NW serves models/aligner._run_ukkonen, align/myers_aligner and
align/hirschberg; Myers bottom rows serve align/myers_aligner and
align/hirschberg.  Each has a Pallas-Triton kernel for the GPU
(ops/nw_diag_pallas.py, ops/myers_pallas.py) and an XLA twin that runs on
any backend (ops/nw_band.py, ops/myers.py), with bit-identical outputs.

Backend strings accepted from the Aligner surface:
  "auto"    the Triton kernel on a GPU, the XLA twin elsewhere; a band wider
            than the kernel holds (r > nw_diag_pallas.MAX_RADIUS) takes the
            XLA twin
  "pallas"  the Triton kernel; raises where it cannot run
  "xla"     the XLA twin

`interpret=True` runs the Triton kernels in Pallas interpret mode on any
backend; only tests pass it.
"""

from typing import NamedTuple

import numpy as np

import jax

BACKENDS = ("auto", "pallas", "xla")


class Traceback(NamedTuple):
    """Move codes of one banded-NW call, tagged with their layout:
    "pallas" is the 2-bit anti-diagonal layout (B, Dpad/4, r+1),
    "xla" the one-code-per-byte row layout (Lq, B, W)."""
    kind: str
    codes: object


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def _kernel_usable(backend: str, interpret: bool) -> bool:
    """Whether `backend` runs the Triton kernel; raises for an explicit
    kernel request the device cannot run."""
    check_backend(backend)
    if backend == "xla":
        return False
    if interpret or on_gpu():
        return True
    if backend == "pallas":
        raise RuntimeError(
            "the Pallas-Triton kernels need a GPU; default backend is "
            f"{jax.default_backend()!r} (use backend='auto' or 'xla')")
    return False


def nw_kind(backend: str, band_radius: int, interpret: bool = False) -> str:
    """'pallas' or 'xla': the banded-NW implementation one call gets."""
    from .nw_diag_pallas import MAX_RADIUS
    if not _kernel_usable(backend, interpret):
        return "xla"
    if band_radius <= MAX_RADIUS:
        return "pallas"
    if backend == "pallas":
        raise ValueError(f"band radius {band_radius} exceeds the Triton "
                         f"kernel's {MAX_RADIUS}")
    return "xla"


def banded_nw(q, qlen, t, tlen, band_radius: int, backend: str = "auto",
              interpret: bool = False):
    """-> (scores (B,) int32, Traceback)."""
    from . import nw_band
    if nw_kind(backend, band_radius, interpret) == "pallas":
        from .nw_diag_pallas import banded_nw_diag_pallas
        sc, tb = banded_nw_diag_pallas(q, qlen, t, tlen, band_radius,
                                       interpret=interpret)
        return sc, Traceback("pallas", tb)
    sc, tb = nw_band.banded_nw(q, qlen, t, tlen, band_radius)
    return sc, Traceback("xla", tb)


def traceback_paths(tb: Traceback, qlen, tlen, band_radius: int) -> list:
    """Download the move codes and decode them on the host (native decoder
    when built, NumPy otherwise) into forward-order AlignmentState lists."""
    from . import nw_band
    codes = np.asarray(tb.codes)
    if tb.kind == "xla":
        return nw_band.traceback_paths(codes, qlen, tlen, band_radius)
    try:
        from ..io import native_traceback
    except ImportError:
        from .nw_diag_pallas import traceback_paths_diag
        return traceback_paths_diag(codes, qlen, tlen, band_radius)
    return native_traceback.decode(codes, qlen, tlen, band_radius,
                                   layout="diag")[0]


def pow2_rows(sel) -> np.ndarray:
    """Row indices `sel` padded to a power-of-two count (at least 8) by
    repeating the first row, so a chunk of any size reuses one compiled
    executable per shape bucket.  Callers keep the first len(sel) results."""
    sel = np.asarray(sel)
    n = max(8, 1 << max(0, int(len(sel) - 1).bit_length()))
    return np.concatenate([sel, np.full(n - len(sel), sel[0], sel.dtype)])


def tb_bytes_per_problem(Lq: int, Lt: int, r: int, kind: str) -> int:
    """Traceback bytes one problem contributes to a dispatch — the number
    the routing and chunking budgets divide by."""
    if kind == "pallas":
        from .nw_diag_pallas import n_diag_bytes
        return n_diag_bytes(Lq, Lt) * (r + 1)
    from . import nw_band
    return Lq * nw_band.band_width(r)                # uint8 row layout


def myers_bottom_row(q, qlen, t, tlen, backend: str = "auto",
                     interpret: bool = False):
    """Myers bottom rows: (rows (B, Lt+1), scores (B,)), from the Triton
    kernel on a GPU and the XLA scan elsewhere."""
    if _kernel_usable(backend, interpret):
        from .myers_pallas import myers_bottom_row_pallas
        return myers_bottom_row_pallas(q, qlen, t, tlen, interpret=interpret)
    from .myers import myers_bottom_row as xla_rows
    return xla_rows(q, qlen, t, tlen)
