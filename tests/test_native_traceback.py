"""Native C++ traceback decoder == the NumPy decoders, bit-for-bit, in the
XLA twin's row layout and the Triton kernel's anti-diagonal layout, and its
fused CIGARs == cpu/nw_oracle.path_to_cigar."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.cpu.nw_oracle import path_to_cigar
from claragenomicsanalysis_tpu.ops import nw_band
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)



@pytest.fixture
def native_traceback(native_libs):
    return pytest.importorskip(
        "claragenomicsanalysis_tpu.io.native_traceback",
        reason="native traceback decoder did not build (g++ missing?)")


def _tb_batch(rng, B=16, Lq=96, Lt=96, r=15):
    qs, ts = [], []
    for b in range(B):
        a = generate_random_genome(int(rng.integers(1, Lq)), rng)
        t = mutate_sequence(a, int(rng.integers(0, 10)), rng)[:Lt]
        qs.append(a)
        ts.append(t)
    q = np.stack([encode(a, Lq) for a in qs]).astype(np.int32)
    t = np.stack([encode(b, Lt) for b in ts]).astype(np.int32)
    qlen = np.array([len(a) for a in qs], np.int32)
    tlen = np.array([len(b) for b in ts], np.int32)
    scores, tb = nw_band.banded_nw(q, qlen, t, tlen, r)
    return np.asarray(tb), qlen, tlen, np.asarray(scores), r


def test_native_matches_python(native_traceback, rng):
    tb, qlen, tlen, scores, r = _tb_batch(rng)
    py = nw_band.traceback_paths(tb, qlen, tlen, r, use_native="never")
    nat, cigars = native_traceback.decode(tb, qlen, tlen, r)
    assert nat == py
    for b, (p, c) in enumerate(zip(py, cigars)):
        if scores[b] < nw_band.INF:
            assert c == path_to_cigar(p)


def test_native_extended_cigar(native_traceback, rng):
    tb, qlen, tlen, scores, r = _tb_batch(rng, B=4)
    py = nw_band.traceback_paths(tb, qlen, tlen, r, use_native="never")
    _, cigars = native_traceback.decode(tb, qlen, tlen, r, extended=True)
    for b, (p, c) in enumerate(zip(py, cigars)):
        if scores[b] < nw_band.INF:
            assert c == path_to_cigar(p, extended=True)


def test_empty_problems(native_traceback):
    tb = np.zeros((4, 2, 128), np.uint8)
    paths, cigars = native_traceback.decode(
        tb, np.array([0, 0], np.int32), np.array([0, 3], np.int32), 15)
    assert paths[0] == [] and cigars[0] == ""
    assert paths[1] == [3, 3, 3] and cigars[1] == "3D"


def test_dispatch_default_uses_native(native_traceback, rng):
    tb, qlen, tlen, _, r = _tb_batch(rng, B=3)
    assert (nw_band.traceback_paths(tb, qlen, tlen, r)
            == nw_band.traceback_paths(tb, qlen, tlen, r, use_native="never"))


def test_garbage_codes_terminate(native_traceback):
    # A band-overflow problem carries garbage move codes.  All-DELETION rows
    # with i > 0 used to decrement j forever; the walk must now stop within
    # qlen+tlen steps and leave a truncated path for callers to drop.
    Lq, B, W = 8, 2, 16
    tb = np.full((Lq, B, W), 3, np.uint8)  # every code = deletion
    qlen = np.array([8, 8], np.int32)
    tlen = np.array([2, 0], np.int32)
    paths, cigars = native_traceback.decode(tb, qlen, tlen, 4)
    for b in range(B):
        assert len(paths[b]) <= qlen[b] + tlen[b] + 1


def _diag_batch(rng, B, L, r, edits):
    from claragenomicsanalysis_tpu.ops.nw_diag_pallas import \
        banded_nw_diag_pallas
    pairs = []
    for _ in range(B):
        a = generate_random_genome(int(rng.integers(1, L - edits)), rng)
        pairs.append((a, mutate_sequence(a, int(rng.integers(0, edits + 1)),
                                         rng)[:L]))
    pairs += [("", "ACG"), ("ACG", ""), ("", ""), ("A" * (L // 2), "A")]
    q = np.stack([encode(a, L) for a, _ in pairs])
    t = np.stack([encode(b, L) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], np.int32)
    tlen = np.array([len(b) for _, b in pairs], np.int32)
    sc, tb = banded_nw_diag_pallas(q, qlen, t, tlen, r, interpret=True)
    return (q, qlen, t, tlen), np.asarray(sc), np.asarray(tb)


@pytest.mark.parametrize("r,L", [(1, 24), (4, 40), (13, 64), (31, 96),
                                 (64, 128)])
def test_native_diag_layout_matches_numpy_and_row_decoder(native_traceback,
                                                          rng, r, L):
    """The anti-diagonal layout: native decode == traceback_paths_diag on
    every problem, and == the XLA twin's row-layout paths wherever the band
    admits a solution."""
    from claragenomicsanalysis_tpu.ops.nw_diag_pallas import \
        traceback_paths_diag
    (q, qlen, t, tlen), sc, tb = _diag_batch(rng, 6, L, r, r)
    nat, cigars = native_traceback.decode(tb, qlen, tlen, r, layout="diag")
    assert nat == traceback_paths_diag(tb, qlen, tlen, r)
    _, row_tb = nw_band.banded_nw(q, qlen, t, tlen, r)
    row = nw_band.traceback_paths(np.asarray(row_tb), qlen, tlen, r,
                                  use_native="never")
    for b, s in enumerate(sc):
        if s < nw_band.INF:
            assert nat[b] == row[b], b
            assert cigars[b] == path_to_cigar(nat[b])


def test_native_rejects_unknown_layout(native_traceback):
    with pytest.raises(ValueError):
        native_traceback.decode(np.zeros((1, 1, 1), np.uint8),
                                np.zeros(1, np.int32), np.zeros(1, np.int32),
                                0, layout="packed")
