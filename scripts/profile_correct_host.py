"""Profile the HOST-side stages of the correction driver at scale.

The polish stage (POA) is the device wall; this script isolates what the
earlier profiles left unprofiled: `_window_supports` (per-overlap Python loop)
and `_align_overlaps` packing, on a correction-shaped synthetic dataset
(reads x coverage), with the POA stage stubbed to a no-op so host time is
visible in isolation.

Run CPU-only:  JAX_PLATFORMS=cpu \
               python scripts/profile_correct_host.py [n_reads] [read_len]
"""

import cProfile
import io
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    from claragenomicsanalysis_tpu.core.config import CorrectConfig
    from claragenomicsanalysis_tpu.io.fasta import FastaParser
    from claragenomicsanalysis_tpu.models import correct as C
    from claragenomicsanalysis_tpu.utils.genomeutils import (
        generate_random_genome, mutate_sequence)

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 5000
    rng = np.random.default_rng(0)
    # reads sampled from one genome so all-vs-all finds real overlaps
    genome = generate_random_genome(read_len * max(4, n_reads // 12), rng)
    reads = []
    for i in range(n_reads):
        start = int(rng.integers(0, len(genome) - read_len))
        reads.append(mutate_sequence(genome[start:start + read_len],
                                     read_len // 20, rng))
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".fasta",
                                     delete=False) as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
        path = f.name
    parser = FastaParser(path)
    cfg = CorrectConfig()

    t0 = time.perf_counter()
    from claragenomicsanalysis_tpu.models.mapper import map_all_vs_all
    overlaps = map_all_vs_all(parser, cfg.mapper).overlaps
    t_map = time.perf_counter() - t0
    print(f"map: {t_map:.2f}s  ({len(overlaps)} overlaps)")

    by_query = {}
    for o in overlaps:
        if max(o.query_end_position_in_read - o.query_start_position_in_read,
               o.target_end_position_in_read
               - o.target_start_position_in_read) > cfg.max_alignment_length:
            continue
        by_query.setdefault(o.query_read_id, []).append(o)

    read_ids = list(range(n_reads))
    part_overlaps = []
    for rid in read_ids:
        part_overlaps.extend(by_query.get(rid, ()))
    t0 = time.perf_counter()
    paths = C._align_overlaps(part_overlaps, parser, cfg)
    t_align = time.perf_counter() - t0
    tot_path = sum(len(p) for p in paths)
    print(f"align_overlaps: {t_align:.2f}s  ({len(part_overlaps)} overlaps, "
          f"{tot_path/1e6:.1f}M path cols)")

    path_of = dict(zip(map(id, part_overlaps), paths))
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    n_jobs = 0
    for rid in read_ids:
        seq = parser.get_sequence_by_id(rid).seq
        ovl = by_query.get(rid, [])
        sup = C._window_supports(seq, ovl, [path_of[id(o)] for o in ovl],
                                 parser, cfg)
        n_jobs += sum(1 for s in sup if len(s) >= cfg.min_supports_for_poa)
    pr.disable()
    t_sup = time.perf_counter() - t0
    print(f"window_supports: {t_sup:.2f}s  ({n_jobs} polishable windows)")
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(15)
    print(s.getvalue())
    total_bases = n_reads * read_len
    print(f"host stages total {t_align + t_sup:.2f}s for "
          f"{total_bases/1e3:.0f} kbases -> ceiling "
          f"{total_bases/1e3/(t_align + t_sup):.1f} kbases/s (host only)")


if __name__ == "__main__":
    main()
