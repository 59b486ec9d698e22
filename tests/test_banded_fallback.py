"""Wide-band routing: a span whose band radius makes the traceback exceed
its kernel's budget must come back as a valid optimal path through
Hirschberg, not a crash, and a band wider than the Triton kernel holds must
take the XLA twin under "auto" with the same paths."""

import numpy as np

from claragenomicsanalysis_tpu.core.config import AlignerConfig
from claragenomicsanalysis_tpu.utils.genomeutils import encode


def _rand(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def test_myers_routes_wide_band_spans_to_hirschberg():
    """A high-error span whose pow2 band radius puts its traceback over the
    selected kernel's budget (here the XLA twin's, on the CPU) must come
    back as a VALID optimal path (via the Hirschberg route), not a
    crash."""
    from claragenomicsanalysis_tpu.align.myers_aligner import \
        myers_align_batch

    rng = np.random.default_rng(3)
    # unrelated 1500 bp sequences: edit distance ~1050 -> r bucket 2048
    qs, ts = [_rand(rng, 1500)], [_rand(rng, 1500)]
    L = 2048
    q = np.full((1, L), -1, np.int8)
    t = np.full((1, L), -1, np.int8)
    q[0, :1500] = encode(qs[0])
    t[0, :1500] = encode(ts[0])
    qlen = np.array([1500], np.int32)
    tlen = np.array([1500], np.int32)
    paths, dists, statuses = myers_align_batch(
        q, qlen, t, tlen, AlignerConfig(L, L, 1, band_radius=2048),
        backend="auto", queries=qs, targets=ts)
    p = paths[0]
    assert p, "no path returned"
    qc = sum(1 for c in p if c in (0, 1, 2))
    tc = sum(1 for c in p if c in (0, 1, 3))
    cost = sum(1 for c in p if c != 0)
    assert (qc, tc) == (1500, 1500)
    assert cost == int(dists[0])   # optimal: matches the Myers score


def test_banded_xla_twin_fallback_paths_correct():
    """A band wider than the Triton kernel holds (r > MAX_RADIUS) takes the
    XLA twin under "auto" even where the kernel is usable, and decodes to
    the same paths as the explicit 'xla' backend."""
    from claragenomicsanalysis_tpu.ops import banded
    from claragenomicsanalysis_tpu.ops.nw_diag_pallas import MAX_RADIUS

    rng = np.random.default_rng(5)
    B, L, r = 2, 64, MAX_RADIUS + 1
    q = np.full((B, L), -1, np.int8)
    t = np.full((B, L), -1, np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        s = _rand(rng, 50)
        m = _rand(rng, 40)           # unrelated: a wide-band problem
        q[b, :len(s)] = encode(s)
        t[b, :len(m)] = encode(m)
        qlen[b], tlen[b] = len(s), len(m)

    sc_p, tb_p = banded.banded_nw(q, qlen, t, tlen, r, "auto",
                                  interpret=True)
    assert tb_p.kind == "xla", "expected the XLA twin fallback"
    sc_x, tb_x = banded.banded_nw(q, qlen, t, tlen, r, "xla")
    assert np.array_equal(np.asarray(sc_p), np.asarray(sc_x))
    assert (banded.traceback_paths(tb_p, qlen, tlen, r)
            == banded.traceback_paths(tb_x, qlen, tlen, r))
