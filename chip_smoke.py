"""End-to-end smoke run on one GPU: the quickest proof that the system runs
on the card.

    python chip_smoke.py [--seed N] [--four-cards] [--correct-reads N]

Phases, in one process, in order (any failure exits non-zero):
  1. build native/ (native/build.sh) and report which host libraries load;
  2. print the card (nvidia-smi name and power limit, JAX device kind);
  3. run the CLI subcommands align, poa, map, pipeline and correct on the
     bundled data/ inputs through cli.main and compare each with its
     data/golden file byte for byte;
  4. run each Triton kernel at real widths against its XLA twin and the
     cpu/ oracle, bit for bit, and time both (warm median of 5 runs);
  5. `map` all-vs-all on 2,000 simulated reads x 10 kb at 5 % error (20x of
     a 1 Mbp genome, -k 15 -w 5, minimap2's ava-ont preset), with recall
     and precision against the simulator's truth via `evaluate`;
  6. `correct` on 1,000 reads x 5 kb at 5 % error (10x), with the
     edit-distance reduction against the truth, wall time and stage times
     (--correct-reads N cuts the reads to N and the genome with them, so
     the coverage stays 10x, and prints the cut).
With --four-cards only two things run, on four GPUs: `map -d 4` and then
`correct -d 4` at the phase 5/6 shapes, each compared byte for byte with
its `-d 1` run, the verdict printed as soon as it is known.

Every input comes from --seed.  The last line of stdout is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.  Without a
GPU the script exits non-zero at once and prints no result.
"""

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*parts) -> None:
    print(*parts, flush=True)


def require_gpu(count: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})")
    if len(devs) < count:
        sys.exit(f"chip_smoke: need {count} GPUs, JAX found {len(devs)}")
    return devs


def phase_native() -> None:
    r = subprocess.run(["sh", os.path.join(ROOT, "native", "build.sh")],
                       capture_output=True, text=True)
    log(r.stdout.strip())
    if r.returncode:
        log(r.stderr.strip())
    loaded = {}
    for mod in ("native_traceback", "native_pack", "native_fasta"):
        try:
            __import__(f"claragenomicsanalysis_tpu.io.{mod}")
            loaded[mod] = "native"
        except ImportError:
            loaded[mod] = "python fallback"
    log("native libraries:", json.dumps(loaded))
    for mod in ("native_traceback", "native_pack"):
        if loaded[mod] != "native":
            raise RuntimeError(f"{mod} did not build")
    if loaded["native_fasta"] != "native":
        log("libfasta did not build (zlib headers missing?): the host FASTA "
            "parser uses its Python fallback")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip()


def phase_goldens() -> None:
    from claragenomicsanalysis_tpu.bench.samples import CASES, run_case
    for name in CASES:
        t0 = time.perf_counter()
        ok = run_case(name)
        log(f"golden {name}: {'equal' if ok else 'DIFFERS'} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"golden {name} differs")


def phase_kernels(seed: int) -> None:
    from claragenomicsanalysis_tpu.bench.kernel_checks import (check_banded,
                                                               check_myers)
    from claragenomicsanalysis_tpu.ops.nw_diag_pallas import MAX_RADIUS
    runs = [
        lambda: check_myers(1024, 512, seed=seed, n_oracle=4),
        lambda: check_myers(256, 2048, seed=seed, n_oracle=1),
        lambda: check_myers(64, 8192, seed=seed, runs=3),
        lambda: check_banded(1024, 512, 64, seed=seed, n_oracle=8),
        lambda: check_banded(64, 4096, 128, seed=seed, n_oracle=1),
        lambda: check_banded(64, 4096, 512, seed=seed, n_oracle=1),
        lambda: check_banded(64, 8192, 128, seed=seed, n_oracle=1),
        lambda: check_banded(64, 8192, 512, seed=seed, n_oracle=1, runs=3),
        lambda: check_banded(4, 8192, MAX_RADIUS, seed=seed, runs=3),
    ]
    for run in runs:
        log("kernel", json.dumps(run()))


def _simulate(work: str, name: str, genome_len: int, reads: int,
              read_len: int, seed: int):
    from claragenomicsanalysis_tpu.bench.samples import run_cli
    fa = os.path.join(work, f"{name}.fasta")
    ref = os.path.join(work, f"{name}_ref.fasta")
    truth = os.path.join(work, f"{name}_truth.tsv")
    if os.path.exists(fa):                     # same seed, same reads
        return fa, ref, truth
    t0 = time.perf_counter()
    out = run_cli(["simulate", "--genome-length", str(genome_len),
                   "--reads", str(reads), "--read-length", str(read_len),
                   "--error-rate", "0.05", "--seed", str(seed),
                   "--reference-out", ref, "--truth-out", truth])
    with open(fa, "w") as f:
        f.write(out)
    log(f"simulated {reads} x {read_len} bp of a {genome_len} bp genome "
        f"(seed {seed}) in {time.perf_counter() - t0:.1f} s")
    return fa, ref, truth


#: (genome bp, reads, read bp) of phases 5 and 6
MAP_SHAPE = (1_000_000, 2000, 10_000)
CORRECT_SHAPE = (500_000, 1000, 5000)
MAP_PRESET = ["-k", "15", "-w", "5"]          # minimap2 ava-ont
CORRECT_FLAGS = MAP_PRESET + ["--min-overlap-len", "100",
                              "--min-overlap-fraction", "0.3",
                              "--min-bases-per-residue", "500",
                              "--max-support", "7"]


def _timed_cli(argv):
    """(stdout, wall s, stage times) of one CLI run; its stderr is echoed
    and must not report an anchor overflow (a truncated map)."""
    from claragenomicsanalysis_tpu.bench.samples import run_cli
    from claragenomicsanalysis_tpu.utils.profiling import (
        reset_stage_timings, stage_timings)
    reset_stage_timings()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        out = run_cli(argv)
    wall = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if "overflowed anchors" in err.getvalue():
        raise AssertionError(f"{argv[0]}: anchors overflowed their cap")
    stages = {k: round(v["total_s"], 3) for k, v in stage_timings().items()}
    return out, wall, stages


def phase_map(work: str, seed: int, devices: int = 1) -> str:
    from claragenomicsanalysis_tpu.bench.samples import run_cli
    genome_len, n, length = MAP_SHAPE
    fa, _, truth = _simulate(work, "map", genome_len, n, length, seed)
    argv = ["map", fa] + MAP_PRESET + ["-d", str(devices)]
    paf, wall, stages = _timed_cli(argv)
    paf_path = os.path.join(work, f"map_d{devices}.paf")
    with open(paf_path, "w") as f:
        f.write(paf)
    metrics = json.loads(run_cli(["evaluate", truth, paf_path]))
    import jax
    peak = (jax.local_devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")
    log("map", json.dumps({"devices": devices, "reads": n,
                           "read_len": length, "overlaps":
                           paf.count("\n"), "wall_s": wall,
                           "mbp_per_s": n * length / 1e6 / wall, **metrics,
                           "peak_device_bytes": peak, "stages": stages}))
    if not (metrics["recall"] >= 0.5 and metrics["precision"] >= 0.9):
        raise AssertionError(f"map quality out of bounds: {metrics}")
    return paf


def phase_correct(work: str, seed: int, devices: int = 1,
                  reads: int = CORRECT_SHAPE[1]) -> str:
    from claragenomicsanalysis_tpu.evaluation import (edit_distances,
                                                      read_truth,
                                                      read_truth_seqs)
    from claragenomicsanalysis_tpu.io.fasta import create_fasta_parser
    genome_len, n, length = CORRECT_SHAPE
    if reads != n:
        log(f"cut: correct on {reads} reads of {length} bp (not {n}), "
            f"genome {genome_len * reads // n} bp, coverage unchanged")
        genome_len, n = genome_len * reads // n, reads
    fa, ref, truth = _simulate(work, "correct", genome_len, n, length,
                               seed + 1)
    out_fa = os.path.join(work, f"corrected_d{devices}.fasta")
    argv = ["correct", fa] + CORRECT_FLAGS + ["-d", str(devices),
                                              "-o", out_fa]
    _, wall, stages = _timed_cli(argv)
    with open(out_fa) as f:
        corrected = f.read()
    if devices == 1:
        genome = create_fasta_parser(ref).get_sequence_by_id(0).seq
        recs = read_truth(truth)
        reads = create_fasta_parser(fa)
        outp = create_fasta_parser(out_fa)
        raw = {r.name: r.seq for r in map(reads.get_sequence_by_id,
                                           range(reads.get_num_sequences()))}
        fixed = {r.name: r.seq for r in map(outp.get_sequence_by_id,
                                            range(outp.get_num_sequences()))}
        assert fixed.keys() == raw.keys(), "corrected reads != input reads"
        names = sorted(raw)
        truths = read_truth_seqs(genome, [recs[k] for k in names])
        raw = [raw[k] for k in names]
        fixed = [fixed[k] for k in names]
        d0 = sum(edit_distances(list(zip(raw, truths))))
        d1 = sum(edit_distances(list(zip(fixed, truths))))
        reduction = 1 - d1 / max(d0, 1)
    else:
        reduction = None
    log("correct", json.dumps({"devices": devices, "reads": n,
                               "read_len": length, "wall_s": wall,
                               "bases_per_s": n * length / wall,
                               "edit_distance_reduction": reduction,
                               "stages": stages}))
    if reduction is not None and reduction < 0.5:
        raise AssertionError(f"correction reduction {reduction:.4f} < 0.5")
    return corrected


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only map -d 4 and correct -d 4 against -d 1")
    ap.add_argument("--correct-reads", type=int,
                    default=CORRECT_SHAPE[1],
                    help="reads of the correct phase (coverage kept)")
    args = ap.parse_args()
    count = 4 if args.four_cards else 1

    sys.path.insert(0, ROOT)
    devs = require_gpu(count)
    from claragenomicsanalysis_tpu.utils.compile_cache import \
        enable_compile_cache
    log("compile cache:", enable_compile_cache())
    t_start = time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            for name, phase in (
                    ("map", phase_map),
                    ("correct", functools.partial(
                        phase_correct, reads=args.correct_reads))):
                one = phase(work, args.seed, devices=1)
                four = phase(work, args.seed, devices=4)
                same = one == four
                log(f"{name} -d 4 vs -d 1: "
                    f"{'byte-identical' if same else 'DIFFERS'}")
                if not same:
                    raise AssertionError(f"{name} -d 4 output differs")
        else:
            phase_native()
            log("card:", card_line(), "| JAX device kind:",
                devs[0].device_kind)
            phase_goldens()
            phase_kernels(args.seed)
            phase_map(work, args.seed)
            phase_correct(work, args.seed, reads=args.correct_reads)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log("card:", card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
