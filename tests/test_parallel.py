"""Distribution tests on the 8-fake-device CPU mesh: N-device output must be
bit-identical to 1-device output (SURVEY.md §4.5 — stronger than the
reference, which has no multi-device tests at all)."""

import numpy as np
import pytest

import jax

from claragenomicsanalysis_tpu.core.config import BatchSize, MapperConfig
from claragenomicsanalysis_tpu.cpu import mapper_oracle as oracle
from claragenomicsanalysis_tpu.io.fasta import FastaParser, FastaSequence
from claragenomicsanalysis_tpu.models.mapper import Index, map_all_vs_all
from claragenomicsanalysis_tpu.ops import nw_band
from claragenomicsanalysis_tpu.parallel import (make_mesh, sharded_banded_nw,
                                                sharded_match_chain,
                                                map_all_vs_all_resumable)
from claragenomicsanalysis_tpu.parallel.index_store import (get_or_build,
                                                            index_key)
from claragenomicsanalysis_tpu.simulators import (NoisyReadSimulator,
                                                  PoissonGenomeSimulator)
from claragenomicsanalysis_tpu.utils.genomeutils import (encode,
                                                         generate_random_genome,
                                                         mutate_sequence)

CFG = MapperConfig(kmer_size=7, window_size=4, min_residues=3,
                   min_overlap_len=30, min_overlap_fraction=0.5,
                   min_bases_per_residue=1000)


def _parser(seqs):
    return FastaParser("<mem>", records=[
        FastaSequence(f"r{i}", s) for i, s in enumerate(seqs)])


def _sim_reads(rng, n=8, glen=800, rlen=200):
    genome = PoissonGenomeSimulator(seed=7).build_reference(glen)
    sim = NoisyReadSimulator(seed=7, error_rate=0.02)
    return [r.seq for r in sim.generate_reads(genome, n, rlen)]


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    mesh = make_mesh(data=2, rep=4)
    assert mesh.shape["rep"] == 4
    with pytest.raises(ValueError):
        make_mesh(data=16)


def test_sharded_aligner_bit_identical(rng):
    pairs = []
    for _ in range(13):  # deliberately not a multiple of 8
        a = generate_random_genome(int(rng.integers(10, 100)), rng)
        b = mutate_sequence(a, 5, rng)
        pairs.append((a, b))
    q = np.stack([encode(a, 112) for a, _ in pairs])
    t = np.stack([encode(b, 112) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], np.int32)
    tlen = np.array([len(b) for _, b in pairs], np.int32)
    s1, tb1 = nw_band.banded_nw(q, qlen, t, tlen, 16)
    mesh = make_mesh(data=8)
    s8, tb8 = sharded_banded_nw(q, qlen, t, tlen, 16, mesh)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s8))
    p1 = nw_band.traceback_paths(np.asarray(tb1), qlen, tlen, 16)
    p8 = nw_band.traceback_paths(np.asarray(tb8), qlen, tlen, 16)
    assert p1 == p8


def test_rep_sharded_matcher_matches_oracle(rng):
    seqs = _sim_reads(rng, n=10)
    p = _parser(seqs)
    idx = Index.create_index(p, 0, len(seqs), CFG)
    mesh = make_mesh(data=1, rep=8)
    out, overflow = sharded_match_chain(idx._arrays, idx._arrays, CFG, mesh,
                                        cap=1 << 14)
    assert not overflow
    sel = np.nonzero(out["valid"])[0]
    got = sorted(
        (int(out["q_read"][i]), int(out["t_read"][i]),
         "+" if out["dir"][i] == 0 else "-",
         int(out["q_start"][i]), int(out["q_end"][i]),
         int(out["t_start"][i]), int(out["t_end"][i]), int(out["n_res"][i]))
        for i in sel)
    want = sorted(
        (o.query_read_id, o.target_read_id, o.relative_strand,
         o.query_start_position_in_read, o.query_end_position_in_read,
         o.target_start_position_in_read, o.target_end_position_in_read,
         o.num_residues) for o in oracle.map_all_vs_all(seqs, CFG))
    assert got == want


def test_resume_bit_identical(rng, tmp_path):
    seqs = _sim_reads(rng, n=6)
    p = _parser(seqs)
    cfg = MapperConfig(kmer_size=7, window_size=4, min_residues=3,
                       min_overlap_len=30, min_overlap_fraction=0.5,
                       min_bases_per_residue=1000, index_size_mb=0)
    ref, computed, skipped = map_all_vs_all_resumable(
        p, cfg, str(tmp_path / "full"))
    assert computed == 36 and skipped == 0
    # crash after 7 pairs, then resume
    with pytest.raises(RuntimeError):
        map_all_vs_all_resumable(p, cfg, str(tmp_path / "crash"),
                                 fail_after_pairs=7)
    res, computed2, skipped2 = map_all_vs_all_resumable(
        p, cfg, str(tmp_path / "crash"))
    assert skipped2 == 7 and computed2 == 29
    assert [o.key() for o in res] == [o.key() for o in ref]
    # and equals the plain driver
    plain = map_all_vs_all(p, cfg)
    assert [o.key() for o in res] == [o.key() for o in plain.overlaps]


def test_index_store_roundtrip(rng, tmp_path):
    seqs = _sim_reads(rng, n=6)
    p = _parser(seqs)
    idx1, cached1 = get_or_build(p, 0, 6, CFG, str(tmp_path))
    idx2, cached2 = get_or_build(p, 0, 6, CFG, str(tmp_path))
    assert not cached1 and cached2
    np.testing.assert_array_equal(idx1.representations(),
                                  idx2.representations())
    np.testing.assert_array_equal(idx1.positions_in_reads(),
                                  idx2.positions_in_reads())
    # key changes with content and params
    assert index_key(p, 0, 6, CFG) != index_key(p, 0, 5, CFG)
    cfg2 = MapperConfig(kmer_size=8, window_size=4)
    assert index_key(p, 0, 6, CFG) != index_key(p, 0, 6, cfg2)


def test_routed_chain_equals_legacy_and_single_device(rng):
    """The query-routed (all_to_all) match+chain must produce EXACTLY the
    overlap set of (a) the legacy all-gather+replicated-chain formulation
    and (b) the plain 1-device driver — across enough reads that every
    shard owns a real query range and buckets take uneven loads."""
    seqs = _sim_reads(rng, n=24, glen=1500, rlen=220)
    p = _parser(seqs)
    idx = Index.create_index(p, 0, len(seqs), CFG)
    mesh = make_mesh(data=1, rep=8)

    def keyset(out):
        sel = np.nonzero(np.asarray(out["valid"]))[0]
        return sorted(
            tuple(int(np.asarray(out[f])[i]) for f in
                  ("q_read", "t_read", "dir", "q_start", "q_end",
                   "t_start", "t_end", "n_res")) for i in sel)

    routed, ov_r = sharded_match_chain(idx._arrays, idx._arrays, CFG, mesh,
                                       cap=1 << 16, route=True)
    legacy, ov_l = sharded_match_chain(idx._arrays, idx._arrays, CFG, mesh,
                                       cap=1 << 16, route=False)
    assert not ov_r and not ov_l
    assert keyset(routed) == keyset(legacy)

    res1 = map_all_vs_all(p, CFG)
    res8 = map_all_vs_all(p, CFG, mesh=mesh)
    assert [o.key() for o in res8.overlaps] == [o.key() for o in res1.overlaps]
    assert np.array_equal(res8.rows, res1.rows)


def test_routed_chain_overflow_flag(rng):
    """An anchor count above the caller's cap must surface as overflow from
    the routed path (the EXCEEDED_MAX_ANCHORS contract)."""
    seqs = _sim_reads(rng, n=10)
    p = _parser(seqs)
    idx = Index.create_index(p, 0, len(seqs), CFG)
    mesh = make_mesh(data=1, rep=8)
    _, overflow = sharded_match_chain(idx._arrays, idx._arrays, CFG, mesh,
                                      cap=64, route=True)
    assert overflow


@pytest.mark.parametrize("rep", [1, 8])
def test_default_anchor_cap_comes_from_bufferplan(rng, monkeypatch, rep):
    """map_all_vs_all's default anchor cap is core.bufferplan's
    device-derived capacity, on the 1-device and the rep-sharded path."""
    from claragenomicsanalysis_tpu.core.status import StatusType
    from claragenomicsanalysis_tpu.models import mapper
    p = _parser(_sim_reads(rng, n=10))
    mesh = make_mesh(data=1, rep=rep) if rep > 1 else None
    assert map_all_vs_all(p, CFG, mesh=mesh).statuses == [StatusType.SUCCESS]
    monkeypatch.setattr(mapper, "anchor_capacity", lambda: 64)
    assert (map_all_vs_all(p, CFG, mesh=mesh).statuses
            == [StatusType.EXCEEDED_MAX_ANCHORS])


def test_routed_chain_unpacked_index_long_reads(rng):
    """Review regression: reads >= 64 KiB build an UNPACKED index (no
    'first_read'/'packed' arrays) — the routed mesh path must handle it,
    not KeyError, and must equal the 1-device driver."""
    genome = PoissonGenomeSimulator(seed=31).build_reference(100_000)
    sim = NoisyReadSimulator(seed=31, error_rate=0.02)
    seqs = [r.seq for r in sim.generate_reads(genome, 3, 70_000)]
    assert max(len(s) for s in seqs) > (1 << 16)
    p = _parser(seqs)
    cfg = MapperConfig(kmer_size=15, window_size=10, min_residues=4,
                       min_overlap_len=500, min_overlap_fraction=0.2,
                       min_bases_per_residue=1000)
    idx = Index.create_index(p, 0, len(seqs), cfg)
    assert "first_read" not in idx._arrays      # really the unpacked path
    res1 = map_all_vs_all(p, cfg)
    res8 = map_all_vs_all(p, cfg, mesh=make_mesh(data=1, rep=8))
    assert [o.key() for o in res8.overlaps] == [o.key() for o in res1.overlaps]
    assert res8.overlaps


def test_sharded_output_merge_equals_replicated(rng, tmp_path):
    """SURVEY §5.8: per-shard part files + deterministic merge must equal
    the replicated-output path byte-for-byte (PAF text), with multiple
    chunk pairs so the (pair, shard) merge order is really exercised."""
    from claragenomicsanalysis_tpu.models.mapper import overlaps_to_paf
    from claragenomicsanalysis_tpu.parallel import (map_all_vs_all_sharded,
                                                    merge_sharded_rows,
                                                    write_merged_paf)
    genome = PoissonGenomeSimulator(seed=23).build_reference(3000)
    sim = NoisyReadSimulator(seed=23, error_rate=0.03)
    seqs = [r.seq for r in sim.generate_reads(genome, 24, 300)]
    p = _parser(seqs)
    # tiny index budget => several chunk pairs
    cfg = MapperConfig(kmer_size=7, window_size=4, min_residues=3,
                       min_overlap_len=30, min_overlap_fraction=0.5,
                       min_bases_per_residue=1000, index_size_mb=1)
    mesh = make_mesh(data=2, rep=4)

    written, n_pairs = map_all_vs_all_sharded(p, cfg, str(tmp_path), mesh)
    assert n_pairs >= 1 and written

    # replicated reference path
    res = map_all_vs_all(p, cfg, mesh=mesh)
    merged = merge_sharded_rows(str(tmp_path))
    assert np.array_equal(merged, res.rows)

    out_paf = tmp_path / "merged.paf"
    n = write_merged_paf(p, str(tmp_path), str(out_paf))
    assert n == len(res.overlaps) > 0
    want = "".join(line + "\n" for line in overlaps_to_paf(res.overlaps, p))
    assert out_paf.read_text() == want
