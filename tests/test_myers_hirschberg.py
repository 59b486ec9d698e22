"""Myers bit-vector + Hirschberg tests vs the oracle."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.core.status import AlignmentState, StatusType
from claragenomicsanalysis_tpu.cpu import nw_oracle as nw
from claragenomicsanalysis_tpu.models import create_aligner
from claragenomicsanalysis_tpu.ops.myers import myers_bottom_row
from claragenomicsanalysis_tpu.utils.genomeutils import (encode,
                                                         generate_random_genome,
                                                         mutate_sequence)


def _pack(pairs, Lq, Lt):
    q = np.stack([encode(a, Lq) for a, _ in pairs])
    t = np.stack([encode(b, Lt) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    tlen = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return q, qlen, t, tlen


def test_myers_bottom_rows_match_oracle(rng):
    pairs = []
    for _ in range(10):
        a = generate_random_genome(int(rng.integers(1, 90)), rng)
        b = mutate_sequence(a, int(rng.integers(0, 15)), rng)
        pairs.append((a, b))
    pairs += [("", "ACG"), ("ACG", ""), ("A" * 33, "A" * 40), ("ANNA", "ANNA")]
    q, qlen, t, tlen = _pack(pairs, 96, 112)
    rows, scores = myers_bottom_row(q, qlen, t, tlen)
    rows, scores = np.asarray(rows), np.asarray(scores)
    for i, (a, b) in enumerate(pairs):
        D = nw.nw_matrix(a, b)
        np.testing.assert_array_equal(rows[i, : len(b) + 1], D[len(a), :])
        assert scores[i] == D[len(a), len(b)]


def test_myers_multiword_boundaries(rng):
    # lengths straddling 32-bit word boundaries
    pairs = []
    for n in (31, 32, 33, 63, 64, 65, 127, 128):
        a = generate_random_genome(n, rng)
        b = mutate_sequence(a, 5, rng)
        pairs.append((a, b))
    q, qlen, t, tlen = _pack(pairs, 136, 152)
    _, scores = myers_bottom_row(q, qlen, t, tlen)
    for i, (a, b) in enumerate(pairs):
        _, d, _ = nw.align(a, b)
        assert np.asarray(scores)[i] == d, (i, len(a))


def test_myers_aligner_paths_are_canonical(rng):
    aligner = create_aligner(128, 128, 32, algorithm="myers")
    pairs = []
    for _ in range(12):
        a = generate_random_genome(int(rng.integers(5, 120)), rng)
        b = mutate_sequence(a, int(rng.integers(0, 20)), rng)[:128]
        pairs.append((a, b))
        aligner.add_alignment(a, b)
    for res, (a, b) in zip(aligner.get_alignments(), pairs):
        o_path, o_dist, _ = nw.align(a, b)   # dense canonical
        assert res.status == StatusType.SUCCESS
        assert res.edit_distance == o_dist
        assert res.path == o_path            # exact canonical path


def test_hirschberg_optimal_and_valid(rng):
    aligner = create_aligner(512, 512, 8, algorithm="hirschberg-myers")
    pairs = []
    for _ in range(6):
        a = generate_random_genome(int(rng.integers(100, 400)), rng)
        b = mutate_sequence(a, int(rng.integers(0, 40)), rng)[:512]
        pairs.append((a, b))
        aligner.add_alignment(a, b)
    for res, (a, b) in zip(aligner.get_alignments(), pairs):
        _, o_dist, _ = nw.align(a, b)
        assert res.status == StatusType.SUCCESS
        # optimal cost
        assert res.edit_distance == o_dist
        # valid path: consumes exactly q and t, cost matches
        qi = sum(1 for s in res.path if s in (0, 1, 2))
        tj = sum(1 for s in res.path if s in (0, 1, 3))
        assert qi == len(a) and tj == len(b)
        cost = sum(1 for s in res.path if s != AlignmentState.MATCH)
        # MISMATCH/INS/DEL each cost 1; recompute true cost from bases
        cost = 0
        i = j = 0
        for s in res.path:
            if s == AlignmentState.MATCH:
                assert a[i] == b[j]; i += 1; j += 1
            elif s == AlignmentState.MISMATCH:
                assert a[i] != b[j]; cost += 1; i += 1; j += 1
            elif s == AlignmentState.INSERTION:
                cost += 1; i += 1
            else:
                cost += 1; j += 1
        assert cost == o_dist


def test_hirschberg_identical_and_empty():
    aligner = create_aligner(256, 256, 4, algorithm="hirschberg-myers")
    aligner.add_alignment("ACGT" * 40, "ACGT" * 40)
    aligner.add_alignment("", "ACGT")
    res = aligner.get_alignments()
    assert res[0].edit_distance == 0
    assert res[0].convert_to_cigar() == "160M"
    assert res[1].convert_to_cigar() == "4D"


def test_myers_long_pair_routes_to_hirschberg(rng):
    """A pair whose banded traceback would exceed TB_BYTES_PER_PROBLEM must
    still produce an optimal path (cost == Myers edit distance)."""
    a = generate_random_genome(2040, rng)
    b = mutate_sequence(a, 45, rng)
    aligner = create_aligner(2048, 2200, 2, algorithm="myers")
    aligner.add_alignment(a, b)
    (res,) = aligner.get_alignments()
    assert res.status == StatusType.SUCCESS
    cost = sum(1 for s in res.path if s != 0)
    assert cost == res.edit_distance
    # the path must be a valid global alignment of the full pair
    qc = sum(1 for s in res.path if s in (0, 1, 2))
    tc = sum(1 for s in res.path if s in (0, 1, 3))
    assert (qc, tc) == (len(a), len(b))


def test_banded_escalate_matches_myers_paths():
    """banded-escalate (score-free) must return byte-identical paths and
    dists to the myers algorithm for spans that resolve in-band — the
    canonical-dense-path theorem both rest on."""
    import numpy as np
    from claragenomicsanalysis_tpu.core.config import AlignerConfig
    from claragenomicsanalysis_tpu.align.myers_aligner import (
        banded_escalate_align_batch, myers_align_batch)
    from claragenomicsanalysis_tpu.utils.genomeutils import encode

    rng = np.random.default_rng(17)

    def rand(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    def mutate(s, frac):
        s = list(s)
        for _ in range(int(len(s) * frac)):
            i = int(rng.integers(0, len(s)))
            op = rng.integers(0, 3)
            if op == 0:
                s[i] = "ACGT"[int(rng.integers(0, 4))]
            elif op == 1 and len(s) > 10:
                del s[i]
            else:
                s.insert(i, "ACGT"[int(rng.integers(0, 4))])
        return "".join(s)

    qs, ts = [], []
    for n, frac in ((200, 0.05), (500, 0.1), (350, 0.02), (500, 0.3)):
        a = rand(n)
        qs.append(a)
        ts.append(mutate(a, frac))
    L = 1024
    B = len(qs)
    q = np.full((B, L), -1, np.int8)
    t = np.full((B, L), -1, np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        q[b, :len(qs[b])] = encode(qs[b])
        t[b, :len(ts[b])] = encode(ts[b])
        qlen[b], tlen[b] = len(qs[b]), len(ts[b])
    cfg = AlignerConfig(L, L, B, band_radius=256)
    p_m, d_m, s_m = myers_align_batch(q, qlen, t, tlen, cfg,
                                      backend="pallas",
                                      queries=qs, targets=ts,
                                      interpret=True)
    p_e, d_e, s_e = banded_escalate_align_batch(q, qlen, t, tlen, cfg,
                                                backend="pallas",
                                                queries=qs, targets=ts,
                                                interpret=True)
    assert list(np.asarray(d_e)) == list(np.asarray(d_m))
    assert p_e == p_m
    assert list(s_e) == list(s_m)
