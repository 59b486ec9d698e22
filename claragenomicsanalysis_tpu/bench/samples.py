"""The bundled sample runs and their golden outputs (data/golden): each CLI
subcommand on the data/ inputs, compared byte for byte.  tests/test_samples.py
runs them on the CPU and chip_smoke.py on the card."""

import contextlib
import io
import os

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data")

MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]

#: name -> (CLI argv, golden file under data/golden)
CASES = {
    "align": (["align", f"{DATA}/sample_queries.fasta",
               f"{DATA}/sample_targets.fasta", "--band-radius", "64"],
              "sample_align.txt"),
    "poa": (["poa", f"{DATA}/sample-windows.txt"], "sample_consensus.txt"),
    "poa_msa": (["poa", f"{DATA}/sample-windows.txt", "--msa"],
                "sample_msa.txt"),
    "map": (["map", f"{DATA}/sample_reads.fasta"] + MAP_ARGS,
            "sample_overlaps.paf"),
    "map_qt": (["map", f"{DATA}/sample_reads.fasta",
                f"{DATA}/sample_targets.fasta"] + MAP_ARGS, "sample_qt.paf"),
    "pipeline": (["pipeline", f"{DATA}/sample_reads.fasta"] + MAP_ARGS
                 + ["--band-radius", "256"], "sample_pipeline.paf"),
    "correct": (["correct", f"{DATA}/sample_reads.fasta"] + MAP_ARGS,
                "sample_corrected.fasta"),
}


def run_cli(argv) -> str:
    """stdout of cli.main(argv), in this process; raises on a non-zero
    return."""
    from ..cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def golden(name: str) -> str:
    with open(os.path.join(DATA, "golden", CASES[name][1])) as f:
        return f.read()


def run_case(name: str) -> bool:
    """True iff the case's output equals its golden file byte for byte."""
    return run_cli(CASES[name][0]) == golden(name)
