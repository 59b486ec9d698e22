"""Read-correction throughput at configurable scale on the accelerator.

Default shape: 1000 x 5 kb (~5 Mb of reads, ~10x coverage, 5 % error).
Prints JSON lines: the compile run, then bases/s of the best warm run and,
with --quality, the edit-distance reduction against the simulated truth.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--read-len", type=int, default=5000)
    ap.add_argument("--coverage", type=float, default=10.0)
    ap.add_argument("--error-rate", type=float, default=0.05)
    ap.add_argument("--runs", type=int, default=1,
                    help="timed runs after the compile run (report best)")
    ap.add_argument("--window-length", type=int, default=None,
                    help="CorrectConfig.window_length override")
    ap.add_argument("--max-support", type=int, default=None)
    ap.add_argument("--quality", action="store_true",
                    help="also report edit-distance-to-truth before/after "
                         "(device Myers)")
    args = ap.parse_args()

    from claragenomicsanalysis_tpu.bench.harness import (device_record,
                                                         require_accelerator)
    from claragenomicsanalysis_tpu.utils.compile_cache import \
        enable_compile_cache
    require_accelerator()
    enable_compile_cache()

    from claragenomicsanalysis_tpu.core.config import (CorrectConfig,
                                                       MapperConfig)
    from claragenomicsanalysis_tpu.io.fasta import FastaParser, FastaSequence
    from claragenomicsanalysis_tpu.models.correct import correct_reads
    from claragenomicsanalysis_tpu.simulators import (NoisyReadSimulator,
                                                      PoissonGenomeSimulator)

    total_bases = args.reads * args.read_len
    glen = max(args.read_len, int(total_bases / args.coverage))
    print(f"simulating {args.reads} x {args.read_len} bp "
          f"({total_bases/1e6:.1f} Mb reads, genome {glen/1e6:.2f} Mb)...",
          flush=True)
    genome = PoissonGenomeSimulator(seed=13).build_reference(glen)
    sim = NoisyReadSimulator(seed=13, error_rate=args.error_rate)
    reads = sim.generate_reads(genome, args.reads, args.read_len)
    parser = FastaParser("<mem>", records=[
        FastaSequence(r.name, r.seq) for r in reads])
    kw = {}
    if args.window_length is not None:
        kw["window_length"] = args.window_length
    if args.max_support is not None:
        kw["max_support"] = args.max_support
    cfg = CorrectConfig(mapper=MapperConfig(kmer_size=15, window_size=5,
                                            min_overlap_len=100,
                                            min_overlap_fraction=0.3,
                                            min_bases_per_residue=500), **kw)

    from claragenomicsanalysis_tpu.utils import profiling

    def timed_run():
        profiling.reset_stage_timings()
        t0 = time.perf_counter()
        r = correct_reads(parser, cfg)
        dt = time.perf_counter() - t0
        stages = {k: round(v["total_s"], 2)
                  for k, v in profiling.stage_timings().items()
                  if k.startswith(("correct.", "mapper.", "aligner."))}
        return r, dt, stages

    res, cold, cold_stages = timed_run()    # compile run
    print(json.dumps({"label": "compile", "wall_s": round(cold, 1),
                      "bases_per_s": round(total_bases / cold, 1),
                      "stages": cold_stages}),
          flush=True)
    best, best_stages = cold, cold_stages
    for _ in range(args.runs):
        res, dt, stages = timed_run()
        if dt < best:
            best, best_stages = dt, stages
    bases = sum(len(r.seq) for r in reads)
    print(json.dumps({
        "metric": f"read-correction bases/s ("
                  f"{args.reads}x{args.read_len//1000}kb @{args.error_rate:.0%} err)",
        "value": round(bases / best, 1), "unit": "bases/s",
        "device": device_record(), "stages": best_stages,
        "detail": f"{res.n_polished}/{res.n_windows} windows polished, "
                  f"{best:.1f} s warm, window_length="
                  f"{cfg.window_length}, max_support={cfg.max_support}"}),
        flush=True)

    if args.quality:
        from claragenomicsanalysis_tpu.evaluation import (TruthRecord,
                                                          edit_distances,
                                                          read_truth_seqs)
        truths = read_truth_seqs(genome, [
            TruthRecord(r.name, r.reference_start, r.reference_end,
                        r.strand) for r in reads])
        d_orig = edit_distances(list(zip([r.seq for r in reads], truths)))
        d_corr = edit_distances(list(zip(res.seqs, truths)))
        so, sc_ = sum(d_orig), sum(d_corr)
        print(json.dumps({
            "metric": "correction edit-distance reduction",
            "value": round(1 - sc_ / max(so, 1), 4), "unit": "fraction",
            "detail": f"sum ed {so} -> {sc_}; mean/read "
                      f"{so/len(reads):.1f} -> {sc_/len(reads):.1f}; "
                      f"improved {sum(c < o for c, o in zip(d_corr, d_orig))}"
                      f"/{len(reads)} reads"}), flush=True)


if __name__ == "__main__":
    main()
