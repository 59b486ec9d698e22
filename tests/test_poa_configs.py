"""The XLA window program (models/poa) against cpu/poa_oracle across the
configurations the POA must hold: noisy and degenerate windows, weights,
overflow statuses, banding and band failure, MSA, other scores, wide
predecessor lists, short and uneven windows — and the data-sharded mesh
run bit-identical to one device."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu.core.status import OutputType, StatusType
from claragenomicsanalysis_tpu.cpu.poa_oracle import poa as oracle_poa
from claragenomicsanalysis_tpu.models.poa import create_batch
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)

BS = BatchSize(max_sequence_size=48, max_sequences_per_poa=6,
               max_pred_per_node=8, max_aligned_per_node=4)


def _noisy(rng, n_windows, lo, hi, max_len=48, max_seqs=6, edits=6):
    groups = []
    for _ in range(n_windows):
        base = generate_random_genome(int(rng.integers(lo, hi)), rng)
        n = int(rng.integers(1, max_seqs + 1))
        groups.append([base] + [
            mutate_sequence(base, int(rng.integers(1, edits)), rng)[:max_len]
            for _ in range(n - 1)])
    return groups


def _check(groups, bs=BS, sc=None, banded=False, msa=False, weights=None,
           mesh=None):
    sc = sc or PoaScores()
    mask = OutputType.CONSENSUS | (OutputType.MSA if msa else 0)
    batch = create_batch(batch_size=bs, scores=sc, output_mask=mask,
                         banded_alignment=banded, mesh=mesh)
    for wi, g in enumerate(groups):
        batch.add_poa_group(g, weights[wi] if weights else None)
    cons, covs, stats = batch.get_consensus()
    msas, _ = batch.get_msa() if msa else ([None] * len(groups), None)
    for wi, g in enumerate(groups):
        o_c, o_cov, o_msa, o_st = oracle_poa(
            g, weights[wi] if weights else None, batch_size=bs, scores=sc,
            output_msa=msa, banded=banded)
        assert stats[wi] == StatusType(o_st), (wi, stats[wi], o_st)
        if o_st == StatusType.SUCCESS:
            assert (cons[wi], covs[wi]) == (o_c, o_cov), wi
            if msa:
                assert msas[wi] == o_msa, wi
    return cons, covs, stats, msas


def test_random_noisy_windows(rng):
    _check(_noisy(rng, 8, 15, 45))


def test_uneven_windows_in_one_batch(rng):
    """Windows of different node counts, lengths and depths side by side
    (what the removed lockstep kernels batched on lanes)."""
    _check(_noisy(rng, 5, 8, 45) + [["A"], ["ACGTACGTACGTACGT"] * 6])


def test_degenerate_windows_and_weights():
    _check([["ACGT"], ["A", "C", "G"], ["TTTTTTTT", "AAAAAAAA"],
            ["ACGT", "ACGT", "ACGT", "ACGT"]])
    _check([["ACTT", "AGTT", "AGTT"]], weights=[[[5] * 4, [1] * 4, [1] * 4]])


def test_overflow_statuses():
    bs = BatchSize(max_sequence_size=16, max_nodes_per_window=12,
                   max_sequences_per_poa=3)
    _check([["ACGTACGTACGT", "TTTTGGGGCCCC"], ["ACG", "ACG"]], bs=bs)


def test_banded_and_band_failure(rng):
    bs = BatchSize(max_sequence_size=32, max_sequences_per_poa=3,
                   band_width=17)
    base = generate_random_genome(28, rng)
    _check([[base, mutate_sequence(base, 3, rng)[:32]]], bs=bs, banded=True)
    bs1 = BatchSize(max_sequence_size=32, max_sequences_per_poa=2,
                    band_width=1)
    _check([["ACGTACGTAC", "ACGTACGTAC"], ["ACGTAC", "TTTTTT"]], bs=bs1,
           banded=True)


def test_msa_matches_oracle(rng):
    _check(_noisy(rng, 5, 12, 38, max_seqs=4)
           + [["ACGT"], ["TTTT", "AAAA", "TAT"]], msa=True)


def test_alternative_scores(rng):
    base = generate_random_genome(30, rng)
    _check([[base, mutate_sequence(base, 4, rng)[:48],
             mutate_sequence(base, 2, rng)[:48]]],
           sc=PoaScores(match_score=4, mismatch_score=-3, gap_score=-2))


def test_wide_predecessor_lists(rng):
    """Many divergent reads: nodes collect many predecessors."""
    bs = BatchSize(max_sequence_size=40, max_sequences_per_poa=12,
                   max_pred_per_node=16, max_aligned_per_node=8)
    _check(_noisy(rng, 3, 20, 36, max_len=40, max_seqs=12, edits=10),
           bs=bs, msa=True)


@pytest.mark.parametrize("n_windows", [3, 13])
def test_mesh_sharded_equals_one_device(rng, n_windows):
    """Windows split over the mesh 'data' axis (a count that does not
    divide the 8 devices included) give the one-device output."""
    from claragenomicsanalysis_tpu.parallel import make_mesh
    groups = _noisy(rng, n_windows, 10, 40, max_seqs=4)
    one = _check(groups, msa=True)
    eight = _check(groups, msa=True, mesh=make_mesh(data=8))
    assert one == eight
