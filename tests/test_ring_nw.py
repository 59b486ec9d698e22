"""Ring-wavefront sequence-parallel NW ('sp' axis): sp-sharded edit distance
== full NW oracle, for several mesh shapes (incl. data x sp), on the
8-fake-device CPU mesh."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.parallel import make_mesh, ring_wavefront_nw
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)


def _batch(rng, B=6, Lq=70, Lt=90):
    qs, ts = [], []
    for b in range(B):
        a = generate_random_genome(int(rng.integers(1, Lq)), rng)
        if b % 2:
            bseq = mutate_sequence(a, int(rng.integers(0, 8)), rng)[:Lt]
        else:
            bseq = generate_random_genome(int(rng.integers(1, Lt)), rng)
        qs.append(a)
        ts.append(bseq)
    q = np.stack([encode(a, Lq) for a in qs]).astype(np.int32)
    t = np.stack([encode(b, Lt) for b in ts]).astype(np.int32)
    qlen = np.array([len(a) for a in qs], np.int32)
    tlen = np.array([len(b) for b in ts], np.int32)
    return qs, ts, q, qlen, t, tlen


def _oracle_dist(qs, ts):
    return np.array([nw_oracle.nw_matrix(a, b)[len(a), len(b)]
                     for a, b in zip(qs, ts)], np.int32)


@pytest.mark.parametrize("data,sp", [(1, 8), (2, 4), (8, 1)])
def test_ring_nw_matches_oracle(rng, data, sp):
    mesh = make_mesh(data=data, rep=1, sp=sp)
    qs, ts, q, qlen, t, tlen = _batch(rng)
    got = ring_wavefront_nw(q, qlen, t, tlen, mesh)
    want = _oracle_dist(qs, ts)
    np.testing.assert_array_equal(got, want)


def test_ring_nw_empty_and_identical(rng):
    mesh = make_mesh(data=1, rep=1, sp=8)
    a = generate_random_genome(40, rng)
    qs = [a, "", a]
    ts = [a, a, ""]
    Lq = Lt = 48
    q = np.stack([encode(s, Lq) for s in qs]).astype(np.int32)
    t = np.stack([encode(s, Lt) for s in ts]).astype(np.int32)
    qlen = np.array([len(s) for s in qs], np.int32)
    tlen = np.array([len(s) for s in ts], np.int32)
    got = ring_wavefront_nw(q, qlen, t, tlen, mesh)
    np.testing.assert_array_equal(got, [0, 40, 40])


def test_ring_nw_sp_count_invariance(rng):
    """The same batch must give identical scores for any sp size."""
    qs, ts, q, qlen, t, tlen = _batch(rng, B=4, Lq=50, Lt=64)
    outs = [ring_wavefront_nw(q, qlen, t, tlen, make_mesh(data=1, rep=1, sp=s))
            for s in (1, 2, 8)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


def test_ring_rows_match_myers_rows(rng):
    """Bottom rows from the sp ring == Myers bottom rows (the Hirschberg
    split input), bit for bit."""
    from claragenomicsanalysis_tpu.ops.myers import myers_bottom_row
    from claragenomicsanalysis_tpu.parallel.ring_nw import (
        ring_wavefront_nw_rows)
    import jax.numpy as jnp
    mesh = make_mesh(data=1, rep=1, sp=8)
    qs, ts, q, qlen, t, tlen = _batch(rng, B=4, Lq=64, Lt=96)
    want = np.asarray(myers_bottom_row(jnp.asarray(q), jnp.asarray(qlen),
                                       jnp.asarray(t), jnp.asarray(tlen))[0])
    got = ring_wavefront_nw_rows(q, qlen, t, tlen, mesh)
    # columns beyond tlen are defined-but-unused by both (callers mask)
    for b in range(len(qs)):
        np.testing.assert_array_equal(got[b, : tlen[b] + 1],
                                      want[b, : tlen[b] + 1])


def test_hirschberg_routes_long_pairs_to_sp(rng, monkeypatch):
    """A pair whose top levels exceed the sp threshold aligns via the
    ring-wavefront rows on the 8-fake-device mesh: Myers is never invoked
    at or above the threshold, and the path cost equals the oracle edit
    distance."""
    from claragenomicsanalysis_tpu.align import hirschberg
    from claragenomicsanalysis_tpu.core.config import AlignerConfig

    a = generate_random_genome(1500, rng)
    b = mutate_sequence(a, 60, rng)
    mesh = make_mesh(data=1, rep=1, sp=8)
    SP_MIN = 512

    real_myers = hirschberg.myers_bottom_row

    def guarded(q, qlen, t, tlen, *args):
        assert t.shape[1] < SP_MIN, (
            "single-device Myers used for a level the sp path must own")
        return real_myers(q, qlen, t, tlen, *args)

    monkeypatch.setattr(hirschberg, "myers_bottom_row", guarded)
    cfg = AlignerConfig(max_query_length=2048, max_target_length=2048,
                        max_alignments=1)
    paths, dists, statuses = hirschberg.hirschberg_align_batch(
        [a], [b], cfg, mesh=mesh, sp_min_len=SP_MIN)
    want = nw_oracle.nw_matrix(a, b)[len(a), len(b)]
    assert int(dists[0]) == int(want)
    # the path must be a valid global alignment of the pair
    nq = sum(1 for s in paths[0] if s in (0, 1, 2))
    nt = sum(1 for s in paths[0] if s in (0, 1, 3))
    assert (nq, nt) == (len(a), len(b))


def test_hirschberg_auto_sp_threshold(rng, monkeypatch):
    """With an sp-capable mesh and NO manual sp_min_len the
    device-memory-derived threshold (core.bufferplan.myers_max_query_len,
    shrunk here by a small device_memory_bytes) routes long levels to the
    ring automatically; single-device Myers never sees a level at/over
    it."""
    from claragenomicsanalysis_tpu.align import hirschberg
    from claragenomicsanalysis_tpu.core import bufferplan
    from claragenomicsanalysis_tpu.core.config import AlignerConfig

    monkeypatch.setattr(bufferplan, "device_memory_bytes",
                        lambda: 512 * 4 * bufferplan.MYERS_LEVEL_BYTES_PER_BASE)
    assert bufferplan.myers_max_query_len() == 512

    a = generate_random_genome(1500, rng)
    b = mutate_sequence(a, 60, rng)
    mesh = make_mesh(data=1, rep=1, sp=8)
    real_myers = hirschberg.myers_bottom_row

    def guarded(q, qlen, t, tlen, *args):
        assert max(q.shape[1], t.shape[1]) < 512, (
            "single-device Myers used for a level the auto sp path must own")
        return real_myers(q, qlen, t, tlen, *args)

    monkeypatch.setattr(hirschberg, "myers_bottom_row", guarded)
    cfg = AlignerConfig(max_query_length=2048, max_target_length=2048,
                        max_alignments=1)
    paths, dists, statuses = hirschberg.hirschberg_align_batch(
        [a], [b], cfg, mesh=mesh)          # no sp_min_len: auto
    want = nw_oracle.nw_matrix(a, b)[len(a), len(b)]
    assert int(dists[0]) == int(want)
