"""Differential fuzz across config corners: device results must equal the
oracles for unusual capacity plans (tight pred/aligned budgets, tiny
windows, different scores), and the mapper across seeds."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.core.config import BatchSize, MapperConfig, PoaScores
from claragenomicsanalysis_tpu.core.status import StatusType
from claragenomicsanalysis_tpu.cpu import mapper_oracle
from claragenomicsanalysis_tpu.cpu.poa_oracle import poa as oracle_poa
from claragenomicsanalysis_tpu.io.fasta import FastaParser, FastaSequence
from claragenomicsanalysis_tpu.models.mapper import map_all_vs_all
from claragenomicsanalysis_tpu.models.poa import create_batch
from claragenomicsanalysis_tpu.simulators import (NoisyReadSimulator,
                                                  PoissonGenomeSimulator)
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)


@pytest.mark.parametrize("pa", [(2, 1), (3, 2), (8, 8)])
def test_poa_tight_capacity_corners(rng, pa):
    P, A = pa
    bs = BatchSize(max_sequence_size=40, max_sequences_per_poa=5,
                   max_pred_per_node=P, max_aligned_per_node=A)
    sc = PoaScores(match_score=5, mismatch_score=-4, gap_score=-3)
    windows = []
    for _ in range(5):
        base = generate_random_genome(int(rng.integers(10, 36)), rng)
        n = int(rng.integers(2, 5))
        windows.append([base] + [
            mutate_sequence(base, int(rng.integers(1, 8)), rng)[:40]
            for _ in range(n - 1)])
    batch = create_batch(batch_size=bs, scores=sc)
    for w in windows:
        batch.add_poa_group(w)
    cons, covs, stats = batch.get_consensus()
    for i, w in enumerate(windows):
        o_c, o_cov, _, o_st = oracle_poa(w, batch_size=bs, scores=sc)
        assert stats[i] == StatusType(o_st), (i, stats[i], o_st)
        if o_st == StatusType.SUCCESS:
            assert cons[i] == o_c
            assert covs[i] == o_cov


@pytest.mark.parametrize("seed", [13, 29, 71])
def test_mapper_seed_fuzz(seed):
    genome = PoissonGenomeSimulator(seed=seed).build_reference(2500)
    sim = NoisyReadSimulator(seed=seed, error_rate=0.04)
    seqs = [r.seq for r in sim.generate_reads(genome, 10, 400)]
    parser = FastaParser("<mem>", records=[
        FastaSequence(f"r{i}", s) for i, s in enumerate(seqs)])
    cfg = MapperConfig(kmer_size=11, window_size=4, min_residues=2,
                       min_overlap_len=40, min_overlap_fraction=0.2,
                       min_bases_per_residue=1000,
                       filtering_parameter=0.2)
    res = map_all_vs_all(parser, cfg)
    want = mapper_oracle.map_all_vs_all(seqs, cfg)
    assert [o.key() for o in res.overlaps] == [o.key() for o in want]


@pytest.mark.parametrize("seed", [13, 71])
def test_mapper_seed_fuzz_mesh_routed(seed):
    """Same differential fuzz through the query-routed mesh path: the
    8-fake-device output must equal the oracle exactly."""
    from claragenomicsanalysis_tpu.parallel import make_mesh
    genome = PoissonGenomeSimulator(seed=seed).build_reference(2500)
    sim = NoisyReadSimulator(seed=seed, error_rate=0.04)
    seqs = [r.seq for r in sim.generate_reads(genome, 10, 400)]
    parser = FastaParser("<mem>", records=[
        FastaSequence(f"r{i}", s) for i, s in enumerate(seqs)])
    cfg = MapperConfig(kmer_size=11, window_size=4, min_residues=2,
                       min_overlap_len=40, min_overlap_fraction=0.2,
                       min_bases_per_residue=1000,
                       filtering_parameter=0.2)
    res = map_all_vs_all(parser, cfg, mesh=make_mesh(data=1, rep=8))
    want = mapper_oracle.map_all_vs_all(seqs, cfg)
    assert [o.key() for o in res.overlaps] == [o.key() for o in want]


def test_mapper_unhashed_and_dense_window():
    """Config corners: unhashed representations (true 2k-bit compare) and
    w=1 (every k-mer is a minimizer) both match the oracle."""
    genome = PoissonGenomeSimulator(seed=3).build_reference(1200)
    sim = NoisyReadSimulator(seed=3, error_rate=0.03)
    seqs = [r.seq for r in sim.generate_reads(genome, 8, 250)]
    parser = FastaParser("<mem>", records=[
        FastaSequence(f"r{i}", s) for i, s in enumerate(seqs)])
    for kw in (dict(kmer_size=9, window_size=1),
               dict(kmer_size=13, window_size=5, hash_representations=False)):
        cfg = MapperConfig(min_residues=2, min_overlap_len=40,
                           min_overlap_fraction=0.2,
                           min_bases_per_residue=1000, **kw)
        res = map_all_vs_all(parser, cfg)
        want = mapper_oracle.map_all_vs_all(seqs, cfg)
        assert [o.key() for o in res.overlaps] == [o.key() for o in want]
        assert res.overlaps
