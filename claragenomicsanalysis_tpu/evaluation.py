"""Mapper evaluation against simulated-read ground truth (reference:
pyclaragenomics' evaluation scripts — bin/assembly_evaluator-style PAF-vs-
truth comparison [U]; exact metrics OURS, documented below).

Truth format (written by ``cli simulate --truth-out``): one TSV row per
read — ``name  reference_start  reference_end  strand``.

A read PAIR is a true overlap when the two reads' genomic intervals
intersect by at least ``min_overlap_bases``.  Reported pairs are the
unordered (query, target) name pairs of the PAF.  Metrics:

- recall    = |reported ∩ true| / |true|
- precision = |reported ∩ true| / |reported|
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class TruthRecord:
    name: str
    start: int
    end: int
    strand: str


def write_truth(reads, path: str) -> None:
    """reads: simulators.readsim.SimulatedRead list."""
    with open(path, "w") as f:
        for r in reads:
            f.write(f"{r.name}\t{r.reference_start}\t{r.reference_end}"
                    f"\t{r.strand}\n")


def read_truth(path: str) -> dict[str, TruthRecord]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            out[parts[0]] = TruthRecord(parts[0], int(parts[1]),
                                        int(parts[2]), parts[3])
    return out


def true_pairs(truth: dict[str, TruthRecord],
               min_overlap_bases: int = 100) -> set[frozenset]:
    recs = list(truth.values())
    recs.sort(key=lambda r: r.start)
    pairs = set()
    for i, a in enumerate(recs):
        for b in recs[i + 1:]:
            if b.start >= a.end - min_overlap_bases + 1:
                break  # sorted by start: no later read can reach back
            if min(a.end, b.end) - max(a.start, b.start) >= min_overlap_bases:
                pairs.add(frozenset((a.name, b.name)))
    return pairs


def evaluate_paf(paf_overlaps, truth: dict[str, TruthRecord],
                 min_overlap_bases: int = 100) -> dict:
    """paf_overlaps: iterable of io.paf.read_paf dicts (keys query_name /
    target_name)."""
    reported = set()
    for o in paf_overlaps:
        q = o["query_name"]
        t = o["target_name"]
        if q != t:
            reported.add(frozenset((q, t)))
    truth_set = true_pairs(truth, min_overlap_bases)
    hit = reported & truth_set
    return {
        "true_pairs": len(truth_set),
        "reported_pairs": len(reported),
        "found_true_pairs": len(hit),
        "recall": len(hit) / len(truth_set) if truth_set else 1.0,
        "precision": len(hit) / len(reported) if reported else 1.0,
    }


def read_truth_seqs(genome: str, records) -> list[str]:
    """Each simulated read's error-free source sequence (its genome span,
    reverse-complemented for '-' strand reads), from TruthRecords."""
    from .utils.genomeutils import reverse_complement
    out = []
    for r in records:
        span = genome[r.start:r.end]
        out.append(reverse_complement(span) if r.strand == "-" else span)
    return out


def edit_distances(pairs: list[tuple[str, str]], chunk: int = 128
                   ) -> list[int]:
    """Global edit distance of each (a, b) pair on the device (Myers bottom
    rows, ops/banded.myers_bottom_row), in pow2-padded chunks."""
    import numpy as np

    from .ops.banded import myers_bottom_row
    from .utils.genomeutils import encode

    def p2(x):
        return max(64, 1 << (max(x, 1) - 1).bit_length())

    out = []
    for s0 in range(0, len(pairs), chunk):
        ch = pairs[s0: s0 + chunk]
        Lq = p2(max(len(a) for a, _ in ch))
        Lt = p2(max(len(b) for _, b in ch))
        B = p2(len(ch))
        q = np.full((B, Lq), -1, np.int8)
        t = np.full((B, Lt), -1, np.int8)
        qlen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        for i, (a, b) in enumerate(ch):
            q[i, : len(a)] = encode(a)
            t[i, : len(b)] = encode(b)
            qlen[i], tlen[i] = len(a), len(b)
        _, sc = myers_bottom_row(q, qlen, t, tlen)
        out.extend(int(x) for x in np.asarray(sc)[: len(ch)])
    return out
