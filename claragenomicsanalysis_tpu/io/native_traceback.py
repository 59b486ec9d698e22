"""ctypes binding for the native C++ traceback decoder
(native/traceback.cpp; build with native/build.sh).

Raises ImportError when the shared library has not been built — callers
(ops/nw_band.traceback_paths) fall back to the vectorized-NumPy decoder,
which produces identical paths (asserted by tests/test_native_traceback.py).
"""

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "_native",
                         "libtraceback.so")
if not os.path.exists(_LIB_PATH):
    raise ImportError(f"native traceback decoder not built ({_LIB_PATH}); "
                      "run native/build.sh")

_lib = ctypes.CDLL(_LIB_PATH)
_lib.cga_tb_decode.restype = ctypes.c_void_p
_lib.cga_tb_decode.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
    ctypes.c_int]
_lib.cga_tb_path_len.restype = ctypes.c_long
_lib.cga_tb_path_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
_lib.cga_tb_path.restype = ctypes.c_void_p
_lib.cga_tb_path.argtypes = [ctypes.c_void_p, ctypes.c_long]
_lib.cga_tb_cigar.restype = ctypes.c_char_p
_lib.cga_tb_cigar.argtypes = [ctypes.c_void_p, ctypes.c_long]
_lib.cga_tb_free.argtypes = [ctypes.c_void_p]


def decode(tb: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
           band_radius: int, extended: bool = False, layout: str = "row"):
    """Decode a traceback array: layout "row" is (Lq, B, W) one code per
    byte (ops/nw_band.banded_nw); "diag" is (B, Dpad/4, r+1) with four
    anti-diagonals per byte (ops/nw_diag_pallas).

    Returns (paths, cigars): per-problem forward-order AlignmentState code
    lists and CIGAR strings (compact M/I/D unless extended)."""
    if layout not in ("row", "diag"):
        raise ValueError(f"unknown traceback layout {layout!r}")
    tb = np.ascontiguousarray(np.asarray(tb).view(np.uint8))
    qlen = np.ascontiguousarray(qlen, dtype=np.int32)
    tlen = np.ascontiguousarray(tlen, dtype=np.int32)
    if layout == "diag":
        B, rows, W = tb.shape
    else:
        rows, B, W = tb.shape
    h = _lib.cga_tb_decode(
        tb.ctypes.data_as(ctypes.c_void_p), rows, B, W,
        qlen.ctypes.data_as(ctypes.c_void_p),
        tlen.ctypes.data_as(ctypes.c_void_p),
        band_radius, 1 if extended else 0, 1 if layout == "diag" else 0)
    if not h:
        raise MemoryError("native traceback allocation failed")
    try:
        paths, cigars = [], []
        for b in range(B):
            n = _lib.cga_tb_path_len(h, b)
            ptr = _lib.cga_tb_path(h, b)
            buf = ctypes.string_at(ptr, n) if n else b""
            paths.append(np.frombuffer(buf, dtype=np.uint8).tolist())
            cigars.append(_lib.cga_tb_cigar(h, b).decode())
        return paths, cigars
    finally:
        _lib.cga_tb_free(h)
