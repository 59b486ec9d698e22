"""Secondary benchmarks on the accelerator: one JSON line per metric
(bench.py prints the aligner-kernel lines).  POA cell-updates/s at the
correction driver's window shape, mapper overlaps/s, pipeline alignments/s
and correction bases/s.  Exits non-zero without an accelerator.

Run: python scripts/bench_all.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _reads(seed, genome_len, n, length):
    from claragenomicsanalysis_tpu.io.fasta import FastaParser, FastaSequence
    from claragenomicsanalysis_tpu.simulators import (NoisyReadSimulator,
                                                      PoissonGenomeSimulator)
    genome = PoissonGenomeSimulator(seed=seed).build_reference(genome_len)
    reads = NoisyReadSimulator(seed=seed, error_rate=0.05).generate_reads(
        genome, n, length)
    return reads, FastaParser("<mem>", records=[
        FastaSequence(r.name, r.seq) for r in reads])


def bench_poa_corr():
    """The window shape the correction driver dispatches at its defaults
    (models/correct._polish_batch_size at full depth), 128 windows."""
    import jax.numpy as jnp
    from claragenomicsanalysis_tpu.bench.harness import (bench_result,
                                                         time_call)
    from claragenomicsanalysis_tpu.core.config import CorrectConfig, PoaScores
    from claragenomicsanalysis_tpu.models.correct import _polish_batch_size
    from claragenomicsanalysis_tpu.models.poa import _build_program
    from claragenomicsanalysis_tpu.utils.genomeutils import (
        encode, generate_random_genome, mutate_sequence)

    cfg = CorrectConfig()
    S = cfg.max_support + 1
    bs = _polish_batch_size(cfg, S)
    program = _build_program(bs, PoaScores(), False, False)
    W, L = 128, bs.padded_seq
    rng = np.random.default_rng(0)
    seqs = np.full((W, S, L), -1, np.int32)
    lens = np.zeros((W, S), np.int32)
    for wi in range(W):
        base = generate_random_genome(cfg.window_length, rng)
        for si in range(S):
            s = mutate_sequence(base, max(5, cfg.window_length // 20),
                                rng)[:bs.max_sequence_size]
            seqs[wi, si, : len(s)] = encode(s)
            lens[wi, si] = len(s)
    args = [jnp.asarray(a) for a in
            (seqs, (seqs >= 0).astype(np.int32), lens, np.full(W, S, np.int32))]
    _, first, dt = time_call(lambda *a: program(*a)[5], *args)
    cells = W * (S - 1) * bs.padded_nodes * (bs.padded_seq + 1)
    return bench_result("POA DP cell-updates/s (correction w128 pileups)",
                        cells / dt / 1e9, "Gcells/s", warm_median_s=dt,
                        first_call_s=first,
                        detail=f"{W} windows x {S} seqs x "
                               f"{cfg.window_length}bp backbone")


def bench_mapper():
    from claragenomicsanalysis_tpu.bench.harness import (bench_result,
                                                         time_call)
    from claragenomicsanalysis_tpu.core.config import MapperConfig
    from claragenomicsanalysis_tpu.models.mapper import map_all_vs_all
    reads, parser = _reads(7, 200_000, 400, 4000)
    cfg = MapperConfig(kmer_size=15, window_size=5)
    res, first, dt = time_call(lambda: map_all_vs_all(parser, cfg), runs=3)
    return bench_result("all-vs-all overlaps/s (400x4kb reads)",
                        len(res.overlaps) / dt, "overlaps/s",
                        warm_median_s=dt, first_call_s=first,
                        overlaps=len(res.overlaps))


def bench_pipeline():
    from claragenomicsanalysis_tpu.bench.harness import (bench_result,
                                                         time_call)
    from claragenomicsanalysis_tpu.core.config import (MapperConfig,
                                                       PipelineConfig)
    from claragenomicsanalysis_tpu.models.pipeline import run_pipeline
    reads, parser = _reads(7, 100_000, 200, 3000)
    cfg = PipelineConfig(mapper=MapperConfig(kmer_size=15, window_size=5))
    res, first, dt = time_call(lambda: run_pipeline(parser, cfg), runs=1)
    return bench_result("overlap->align CIGAR'd alignments/s (200x3kb)",
                        len(res.paf_rows) / dt, "alignments/s",
                        warm_s=dt, first_call_s=first,
                        failed=res.n_align_failed)


def bench_correct():
    from claragenomicsanalysis_tpu.bench.harness import (bench_result,
                                                         time_call)
    from claragenomicsanalysis_tpu.core.config import (CorrectConfig,
                                                       MapperConfig)
    from claragenomicsanalysis_tpu.models.correct import correct_reads
    reads, parser = _reads(13, 40_000, 200, 2000)
    cfg = CorrectConfig(mapper=MapperConfig(kmer_size=15, window_size=5,
                                            min_overlap_len=100,
                                            min_overlap_fraction=0.3,
                                            min_bases_per_residue=500))
    res, first, dt = time_call(lambda: correct_reads(parser, cfg), runs=1)
    bases = sum(len(r.seq) for r in reads)
    return bench_result("read-correction bases/s (200x2kb @5% err)",
                        bases / dt, "bases/s", warm_s=dt, first_call_s=first,
                        polished=f"{res.n_polished}/{res.n_windows}")


def main():
    from claragenomicsanalysis_tpu.bench.harness import require_accelerator
    from claragenomicsanalysis_tpu.utils.compile_cache import \
        enable_compile_cache
    require_accelerator()
    enable_compile_cache()
    for fn in (bench_poa_corr, bench_mapper, bench_pipeline, bench_correct):
        print(json.dumps(fn()), flush=True)


if __name__ == "__main__":
    main()
