"""Read-correction driver (BASELINE config #5): quality, N-device == 1-device
bit-exactness, and checkpoint/resume."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.core.config import CorrectConfig, MapperConfig
from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.io.fasta import FastaParser, FastaSequence
from claragenomicsanalysis_tpu.models.correct import correct_reads, write_fasta
from claragenomicsanalysis_tpu.simulators.genomesim import PoissonGenomeSimulator
from claragenomicsanalysis_tpu.simulators.readsim import NoisyReadSimulator
from claragenomicsanalysis_tpu.utils.genomeutils import reverse_complement


def _edist(a, b):
    return int(nw_oracle.nw_matrix(a, b)[len(a), len(b)])


@pytest.fixture(scope="module")
def dataset():
    genome = PoissonGenomeSimulator(seed=11).build_reference(800)
    sim = NoisyReadSimulator(seed=11, error_rate=0.04)
    reads = sim.generate_reads(genome, 20, 250)  # ~6x coverage
    parser = FastaParser("<mem>", records=[
        FastaSequence(r.name, r.seq) for r in reads])
    cfg = CorrectConfig(
        mapper=MapperConfig(kmer_size=11, window_size=5, min_overlap_len=50,
                            min_overlap_fraction=0.2,
                            min_bases_per_residue=500),
        window_length=100, max_support=7)
    return genome, reads, parser, cfg


@pytest.fixture(scope="module")
def corrected(dataset):
    _, _, parser, cfg = dataset
    return correct_reads(parser, cfg)


def test_correct_improves_reads(dataset, corrected):
    genome, reads, _, _ = dataset
    before = after = 0
    for r, cor in zip(reads, corrected.seqs):
        true = genome[r.reference_start:r.reference_end]
        if r.strand == "-":
            true = reverse_complement(true)
        before += _edist(r.seq, true)
        after += _edist(cor, true)
    assert corrected.n_windows > 0
    assert corrected.n_polished > 0
    assert after < before, f"correction should reduce errors ({before}->{after})"


def test_correct_mesh_bit_identical(dataset, corrected):
    """8-fake-device mesh output == 1-device output, byte for byte — the
    BASELINE determinism requirement through the user-facing driver."""
    from claragenomicsanalysis_tpu.parallel import make_mesh
    _, _, parser, cfg = dataset
    res8 = correct_reads(parser, cfg, mesh=make_mesh())
    assert res8.seqs == corrected.seqs
    assert (res8.n_windows, res8.n_polished, res8.n_window_failed) == \
        (corrected.n_windows, corrected.n_polished, corrected.n_window_failed)


def test_correct_resume(dataset, corrected, tmp_path):
    """A crash mid-run resumes from checkpoints and yields identical output."""
    _, _, parser, cfg = dataset
    work = str(tmp_path / "work")
    with pytest.raises(RuntimeError, match="injected failure"):
        correct_reads(parser, cfg, work_dir=work, part_size=4,
                      fail_after_parts=1)
    res = correct_reads(parser, cfg, work_dir=work, part_size=4)
    assert res.seqs == corrected.seqs


def test_write_fasta_roundtrip(dataset, corrected, tmp_path):
    _, _, parser, _ = dataset
    out = str(tmp_path / "corrected.fasta")
    write_fasta(corrected, out)
    back = FastaParser(out)
    assert back.get_num_sequences() == len(corrected.seqs)
    assert [back.get_sequence_by_id(i).seq
            for i in range(back.get_num_sequences())] == corrected.seqs


def test_cli_correct(dataset, corrected, tmp_path, capsys):
    from claragenomicsanalysis_tpu.cli import main
    _, reads, _, _ = dataset
    fa = tmp_path / "reads.fasta"
    fa.write_text("".join(f">{r.name}\n{r.seq}\n" for r in reads))
    rc = main(["correct", str(fa), "-k", "11", "-w", "5",
               "--min-overlap-len", "50", "--min-overlap-fraction", "0.2",
               "--min-bases-per-residue", "500",
               "--window-length", "100", "--max-support", "7"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.strip().split("\n")
    assert lines[0].startswith(">")
    seqs = [lines[i] for i in range(1, len(lines), 2)]
    assert seqs == corrected.seqs


def _randseq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _mutate(rng, s, n):
    s = list(s)
    for _ in range(n):
        i = int(rng.integers(0, len(s)))
        s[i] = "ACGT"[int(rng.integers(0, 4))]
    return "".join(s)


def test_polish_depth_buckets_match_global_shape():
    """Round-4 regression (aec78f7): the depth-bucketed polish dispatch
    must produce the SAME consensus per window as the old single global
    max_support-shaped dispatch — a window's result may not depend on
    which pow2 depth bucket its pileup landed in (caps follow the same
    depth-scaling rule, applied per bucket)."""
    from claragenomicsanalysis_tpu.core.status import StatusType
    from claragenomicsanalysis_tpu.models.correct import (_polish_batch_size,
                                                          _polish_windows)
    from claragenomicsanalysis_tpu.models.poa import create_batch

    rng = np.random.default_rng(7)
    cfg = CorrectConfig(window_length=100, max_support=7)
    jobs = []
    for depth in (2, 3, 5, 8, 4, 8, 2):     # spans buckets 4 and 8
        bb = _randseq(rng, 90)
        jobs.append([bb] + [_mutate(rng, bb, 5) for _ in range(depth - 1)])

    bucketed, n_failed = _polish_windows(jobs, cfg, None, None)

    # unbucketed baseline: every job at the one global max-depth shape
    bs = _polish_batch_size(cfg, cfg.max_support + 1)
    batch = create_batch(batch_size=bs, max_poas=len(jobs))
    for seqs in jobs:
        batch.add_poa_group(seqs)
    batch.generate_poa()
    cons, _, stats = batch.get_consensus()
    expect = [c if st == StatusType.SUCCESS and c else seqs[0]
              for seqs, c, st in zip(jobs, cons, stats)]
    assert bucketed == expect
    assert n_failed == sum(st != StatusType.SUCCESS for st in stats)


def test_align_overlap_span_buckets_stay_optimal():
    """Round-4 regression (aec78f7): per-span pow2 length bucketing in
    _align_overlaps must keep every span's path a VALID alignment (codes
    consume exactly the span lengths) with the SAME optimal edit cost as
    the old global-max-bucket packing.  Paths themselves may tie-break
    differently near routing boundaries (see the docstring), so the
    assertion is on cost + validity, not byte-equality."""
    from claragenomicsanalysis_tpu.core.types import Overlap
    from claragenomicsanalysis_tpu.models.correct import _align_overlaps

    rng = np.random.default_rng(11)
    # heterogeneous span lengths: 60, 200, 900 bp (buckets 64/256/1024)
    srcs = [_randseq(rng, n) for n in (60, 200, 900)]
    recs, overlaps = [], []
    for i, s in enumerate(srcs):
        t = _mutate(rng, s, max(2, len(s) // 20))
        recs += [FastaSequence(f"q{i}", s), FastaSequence(f"t{i}", t)]
        overlaps.append(Overlap(2 * i, 2 * i + 1, 0, len(s), 0, len(t), 5))
    parser = FastaParser("<mem>", records=recs)
    cfg = CorrectConfig()

    def costs(paths):
        # edit cost = non-match columns (codes: 0 match, 1 mismatch,
        # 2 insertion, 3 deletion)
        return [sum(1 for c in p if c != 0) for p in paths]

    def check_valid(paths):
        for o, p in zip(overlaps, paths):
            assert p, "span unexpectedly unalignable"
            qlen = sum(1 for c in p if c in (0, 1, 2))
            tlen = sum(1 for c in p if c in (0, 1, 3))
            assert qlen == o.query_end_position_in_read
            assert tlen == o.target_end_position_in_read

    bucketed = _align_overlaps(overlaps, parser, cfg)
    check_valid(bucketed)

    # old behavior: one global bucket sized by the longest span — force
    # the single-bucket packing by padding every span through the largest
    # aligner shape
    from claragenomicsanalysis_tpu.core.status import StatusType
    from claragenomicsanalysis_tpu.models.aligner import create_aligner
    L = 1024
    aligner = create_aligner(L, L, len(overlaps),
                             band_radius=min(cfg.aligner_band_radius, L),
                             algorithm="myers")
    for i, s in enumerate(srcs):
        aligner.add_alignment(s, parser.get_sequence_by_id(2 * i + 1).seq)
    glob = [a.path if a.status == StatusType.SUCCESS else []
            for a in aligner.get_alignments()]
    check_valid(glob)
    assert costs(bucketed) == costs(glob)
