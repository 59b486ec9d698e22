"""Anti-diagonal banded-NW Triton kernel (Pallas interpret mode on the CPU)
vs the XLA scan twin and the cpu/nw_oracle banded DP: scores, decoded paths
and the 2-bit move code of every reachable in-band cell bit-equal
(ops/nw_diag_pallas.py, bench/kernel_checks.py)."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.bench.kernel_checks import (check_banded,
                                                           diag_codes)
from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.ops import nw_band
from claragenomicsanalysis_tpu.ops.nw_diag_pallas import (
    MAX_RADIUS, banded_nw_diag_pallas, tile_shape, traceback_paths_diag)
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)


def _pack(pairs, Lq, Lt):
    q = np.stack([encode(a, Lq) for a, _ in pairs])
    t = np.stack([encode(b, Lt) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    tlen = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return q, qlen, t, tlen


def _check(pairs, Lq, Lt, r):
    q, qlen, t, tlen = _pack(pairs, Lq, Lt)
    s_scan, tb_scan = nw_band.banded_nw(q, qlen, t, tlen, r)
    s_d, tb_d = banded_nw_diag_pallas(q, qlen, t, tlen, r, interpret=True)
    s_d = np.asarray(s_d)
    np.testing.assert_array_equal(np.asarray(s_scan), s_d)
    p_scan = nw_band.traceback_paths(np.asarray(tb_scan), qlen, tlen, r,
                                     use_native="never")
    p_d = traceback_paths_diag(np.asarray(tb_d), qlen, tlen, r)
    for b, (a, c) in enumerate(pairs):
        if s_d[b] >= int(nw_band.INF):
            # outside the band: status + empty path in the aligner
            assert abs(len(a) - len(c)) > r
            continue
        assert p_scan[b] == p_d[b], b
        path, score, _ = nw_oracle.align(a, c, r)
        assert (int(s_d[b]), p_d[b]) == (score, path), b


@pytest.mark.parametrize("r", [1, 2, 3, 4, 8, 13, 31, 64])
def test_band_radii(rng, r):
    pairs = []
    for _ in range(5):
        a = generate_random_genome(int(rng.integers(1, 90)), rng)
        b = mutate_sequence(a, int(rng.integers(0, r + 1)), rng)[:96]
        pairs.append((a, b))
    # boundary rows/cols, empty-vs-empty, and a pair outside the band
    pairs += [("", "ACG"), ("ACG", ""), ("", ""), ("A" * 50, "A" * 3)]
    _check(pairs, 96, 104, r)


def test_asymmetric_lengths(rng):
    pairs = []
    for _ in range(6):
        a = generate_random_genome(int(rng.integers(20, 100)), rng)
        b = mutate_sequence(a, int(rng.integers(0, 12)), rng)[
            : int(rng.integers(8, 64))]
        pairs.append((a, b))
    _check(pairs, 104, 64, 16)


def test_batch_padding_and_ambiguous_bases():
    """B not a multiple of the program's problem block; N never matches."""
    bb = tile_shape(4)[0]
    pairs = [("ACGT", "ACGA"), ("A", "T"), ("GG", "GG"), ("ANNA", "ANNA")]
    pairs += [("ACGTAC", "ACGTAC")] * (bb + 1 - len(pairs))
    q, qlen, t, tlen = _pack(pairs, 8, 8)
    s, tb = banded_nw_diag_pallas(q, qlen, t, tlen, 4, interpret=True)
    assert list(np.asarray(s))[:4] == [1, 1, 0, 2]
    assert np.asarray(tb).shape == (len(pairs), (8 + 8 + 4) // 4, 5)


@pytest.mark.parametrize("r", [2, 7, 16])
def test_move_codes_equal_oracle_on_every_reachable_cell(r):
    """kernel_checks.check_banded: codes of every reachable in-band cell ==
    the oracle's tie-break == the XLA twin's, plus scores and paths."""
    out = check_banded(6, 48, r, seed=r, n_oracle=6, runs=1,
                       interpret=True)
    assert out["equal"] and out["oracle_cells"] > 0


def test_diag_codes_address_the_layout():
    """diag_codes reads cell (i, j) at diagonal i+j, half-band cell
    (j-i+r-par)/2, bits 2*(d%4)."""
    r = 3
    tb = np.zeros((1, 4, r + 1), np.uint8)
    i, j = np.array([2]), np.array([3])        # d = 5, par = 0, k = 2
    tb[0, 1, 2] = 0b11 << 2
    assert diag_codes(tb, 0, i, j, r)[0] == 3


def test_radius_bounds():
    q = np.zeros((1, 8), np.int8)
    n = np.ones(1, np.int32)
    with pytest.raises(ValueError):
        banded_nw_diag_pallas(q, n, q, n, MAX_RADIUS + 1, interpret=True)
