"""Checks of the Triton kernels against their XLA twins and the CPU oracles,
with timings.  chip_smoke.py's kernel phase runs them at real widths on the
card; tests/test_gpu_kernels.py runs them at small widths under the `gpu`
marker; the CPU tests run them with interpret=True at toy widths.

Every output compared is an integer — scores, Myers bottom rows, 2-bit
move codes, decoded paths — so equality is exact.  No float product
appears on these paths, so TF32 and summation order do not arise.

Each check raises AssertionError on the first mismatch and otherwise
returns a dict of what it compared and how long each side took: the warm
median of `runs` calls ending in block_until_ready, with the first
(compiling) call reported apart.
"""

import time

import numpy as np

from ..core.status import AlignmentState
from ..cpu import nw_oracle
from ..ops import banded, nw_band
from ..utils.genomeutils import encode, generate_random_genome, \
    mutate_sequence
from .harness import time_call


def random_pairs(B: int, L: int, edits: int, seed: int):
    """B pairs: a random L-2*edits bp query and a copy with `edits` random
    substitutions/insertions/deletions, padded to L.  -> (q, qlen, t, tlen)
    as int8/int32 NumPy arrays, and the query/target strings."""
    rng = np.random.default_rng(seed)
    qs = [generate_random_genome(L - 2 * edits, rng) for _ in range(B)]
    ts = [mutate_sequence(a, edits, rng)[:L] for a in qs]
    q = np.stack([encode(a, L) for a in qs]).astype(np.int8)
    t = np.stack([encode(b, L) for b in ts]).astype(np.int8)
    qlen = np.array([len(a) for a in qs], np.int32)
    tlen = np.array([len(b) for b in ts], np.int32)
    return (q, qlen, t, tlen), qs, ts


def _host_timed(fn, runs: int):
    """Median host time of fn() (its result is host data: no device wait)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def check_myers(B: int, L: int, *, seed: int = 0, n_oracle: int = 0,
                runs: int = 5, interpret: bool = False) -> dict:
    """Myers bottom rows: Triton kernel == XLA scan twin on all B problems,
    and == cpu/nw_oracle.nw_matrix's last row (columns 0..tlen) on the
    first n_oracle problems."""
    from ..ops.myers import myers_bottom_row as xla_rows
    from ..ops.myers_pallas import myers_bottom_row_pallas
    (q, qlen, t, tlen), qs, ts = random_pairs(B, L, max(1, L // 40), seed)
    (k_rows, k_sc), k_first, k_t = time_call(
        lambda: myers_bottom_row_pallas(q, qlen, t, tlen,
                                        interpret=interpret), runs=runs)
    (x_rows, x_sc), x_first, x_t = time_call(
        lambda: xla_rows(q, qlen, t, tlen), runs=runs)
    k_rows, x_rows = np.asarray(k_rows), np.asarray(x_rows)
    assert np.array_equal(k_rows, x_rows), "Myers rows != XLA twin"
    assert np.array_equal(np.asarray(k_sc), np.asarray(x_sc)), \
        "Myers scores != XLA twin"
    for b in range(min(n_oracle, B)):
        want = nw_oracle.nw_matrix(qs[b], ts[b])[len(qs[b])]
        assert np.array_equal(k_rows[b, :len(ts[b]) + 1], want), \
            f"Myers row {b} != oracle"
    return {"op": "myers", "B": B, "Lq": L, "Lt": L, "oracle_problems":
            min(n_oracle, B), "equal": True,
            "triton_s": k_t, "triton_first_s": k_first,
            "xla_s": x_t, "xla_first_s": x_first}


def _oracle_cells(a: str, b: str, r: int):
    """(i, j, code) of every reachable in-band cell with i >= 1 under the
    oracle's banded DP and the package tie-break (diag, then DELETION via
    left + 1, else INSERTION)."""
    D, status = nw_oracle.nw_banded_matrix(a, b, r)
    qa, ta = encode(a).astype(np.int64), encode(b).astype(np.int64)
    n, m = len(qa), len(ta)
    if status != 0 or n == 0:
        return (np.zeros(0, np.int64),) * 3
    D = D.astype(np.int64)
    i, j = np.nonzero(D[1:] < int(nw_band.INF))
    i = i + 1
    cur = D[i, j]
    jm = np.maximum(j - 1, 0)
    sub = np.where((j > 0) & (qa[i - 1] == ta[jm]) & (qa[i - 1] >= 0), 0, 1)
    diag = np.where(j > 0, D[i - 1, jm] + sub, -1)
    left = np.where(j > 0, D[i, jm] + 1, -1)
    code = np.where(cur == diag, sub,
                    np.where(cur == left, int(AlignmentState.DELETION),
                             int(AlignmentState.INSERTION)))
    return i, j, code


def diag_codes(tb: np.ndarray, b: int, i, j, r: int) -> np.ndarray:
    """Codes of cells (i, j) of problem b from the kernel's 2-bit
    anti-diagonal layout (B, Dpad/4, r+1)."""
    tb = np.asarray(tb).view(np.uint8)
    d = i + j
    k = (j - i + r - ((d + r) & 1)) >> 1
    return (tb[b, d >> 2, k] >> (2 * (d & 3))) & 3


def row_codes(tb: np.ndarray, b: int, i, j, r: int) -> np.ndarray:
    """Codes of cells (i, j) of problem b from the XLA twin's row layout."""
    return np.asarray(tb)[i - 1, b, r + j - i]


def check_banded(B: int, L: int, r: int, *, seed: int = 0,
                 n_oracle: int = 0, runs: int = 5,
                 interpret: bool = False) -> dict:
    """Banded NW: Triton diag kernel == XLA twin on scores and decoded paths
    of all B problems, and on the move code of every reachable in-band
    cell of the first n_oracle problems, where the codes also equal the
    oracle's (cpu/nw_oracle.nw_banded_matrix + tie-break) and the paths
    equal nw_oracle.align's.  Times the kernel alone and end to end
    (kernel, download, host decode) for both sides."""
    from ..ops.nw_diag_pallas import banded_nw_diag_pallas
    (q, qlen, t, tlen), qs, ts = random_pairs(B, L, max(1, r // 2), seed)

    def k_call():
        return banded_nw_diag_pallas(q, qlen, t, tlen, r,
                                     interpret=interpret)

    (k_sc, k_tb), k_first, k_t = time_call(k_call, runs=runs)
    k_paths, k_e2e = _host_timed(
        lambda: banded.traceback_paths(banded.Traceback("pallas",
                                                        k_call()[1]),
                                       qlen, tlen, r), runs)
    (x_sc, x_tb), x_first, x_t = time_call(
        lambda: nw_band.banded_nw(q, qlen, t, tlen, r), runs=runs)
    x_paths, x_e2e = _host_timed(
        lambda: banded.traceback_paths(banded.Traceback(
            "xla", nw_band.banded_nw(q, qlen, t, tlen, r)[1]),
            qlen, tlen, r), runs)
    k_sc, k_tb = np.asarray(k_sc), np.asarray(k_tb)
    x_sc, x_tb = np.asarray(x_sc), np.asarray(x_tb)
    assert np.array_equal(k_sc, x_sc), "banded scores != XLA twin"
    for b in range(B):
        if k_sc[b] < int(nw_band.INF):
            assert k_paths[b] == x_paths[b], f"path {b} != XLA twin"
    cells = 0
    for b in range(min(n_oracle, B)):
        i, j, code = _oracle_cells(qs[b], ts[b], r)
        assert np.array_equal(diag_codes(k_tb, b, i, j, r), code), \
            f"move codes of problem {b} != oracle"
        assert np.array_equal(row_codes(x_tb, b, i, j, r), code), \
            f"XLA twin move codes of problem {b} != oracle"
        path, score, _ = nw_oracle.align(qs[b], ts[b], r)
        assert int(k_sc[b]) == score and k_paths[b] == path, \
            f"problem {b} != oracle"
        cells += len(code)
    return {"op": "banded_nw", "B": B, "Lq": L, "Lt": L, "r": r,
            "in_band": int((k_sc < int(nw_band.INF)).sum()),
            "triton_s": k_t, "triton_first_s": k_first,
            "triton_e2e_s": k_e2e, "tb_bytes": int(k_tb.nbytes),
            "xla_s": x_t, "xla_first_s": x_first, "xla_e2e_s": x_e2e,
            "oracle_problems": min(n_oracle, B), "oracle_cells": cells,
            "equal": True}
