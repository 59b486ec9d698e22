"""Triton Myers bit-vector kernel (Pallas interpret mode on the CPU) vs the
XLA scan twin and the cpu/nw_oracle DP: bottom rows and scores bit-identical,
including word boundaries, empty sides, N bases, batches that are not a
multiple of the program block, and queries split over several strips."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.ops.myers import myers_bottom_row
from claragenomicsanalysis_tpu.ops.myers_pallas import (BLOCK_B,
                                                         myers_bottom_row_pallas)
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)


def _pack(pairs, Lq, Lt):
    q = np.stack([encode(a, Lq) for a, _ in pairs]).astype(np.int8)
    t = np.stack([encode(b, Lt) for _, b in pairs]).astype(np.int8)
    qlen = np.array([len(a) for a, _ in pairs], np.int32)
    tlen = np.array([len(b) for _, b in pairs], np.int32)
    return q, qlen, t, tlen


def _check(pairs, Lq, Lt, strip_words=None):
    q, qlen, t, tlen = _pack(pairs, Lq, Lt)
    r1, s1 = myers_bottom_row(q, qlen, t, tlen)
    kw = {} if strip_words is None else {"strip_words": strip_words}
    r2, s2 = myers_bottom_row_pallas(q, qlen, t, tlen, interpret=True, **kw)
    r2 = np.asarray(r2)
    np.testing.assert_array_equal(np.asarray(r1), r2)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    for b, (a, c) in enumerate(pairs):
        want = nw_oracle.nw_matrix(a, c)[len(a)]
        np.testing.assert_array_equal(r2[b, :len(c) + 1], want)


@pytest.mark.parametrize("n", [31, 32, 33, 64, 65])
def test_word_boundaries(rng, n):
    """qlen at and around 32-bit word edges (the bottom-row bit pick)."""
    pairs = []
    for _ in range(3):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a, 3, rng)[:100]))
    _check(pairs, 96, 104)


def test_empty_query_and_target(rng):
    a = generate_random_genome(40, rng)
    _check([("", "ACGT"), (a, ""), ("", ""), ("A", "A")], 64, 48)


def test_ambiguous_bases_never_match():
    _check([("ACGNNT", "ACGNNT"), ("NNNN", "NNNN"), ("ACGT", "ANGT")],
           32, 32)


def test_batch_not_multiple_of_block(rng):
    pairs = []
    for _ in range(BLOCK_B + 5):
        a = generate_random_genome(int(rng.integers(1, 60)), rng)
        pairs.append((a, mutate_sequence(a, int(rng.integers(0, 6)),
                                         rng)[:64]))
    _check(pairs, 64, 64)


@pytest.mark.parametrize("strip_words", [1, 2, 3])
def test_multi_strip_queries(rng, strip_words):
    """Queries longer than one strip hand the horizontal carry from strip
    to strip; bottom rows come from the strip holding the last base."""
    pairs = []
    for n in (20, 40, 70, 95, 128):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a, 5, rng)[:120]))
    _check(pairs, 128, 120, strip_words=strip_words)


def test_target_longer_than_query(rng):
    a = generate_random_genome(30, rng)
    b = generate_random_genome(150, rng)
    _check([(a, b), (a, a + b[:90])], 32, 160)
