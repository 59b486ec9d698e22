"""Global-mesh construction (8 fake devices) + the simulate CLI."""

import subprocess
import sys

import jax

from claragenomicsanalysis_tpu.parallel import (initialize_distributed,
                                                make_global_mesh,
                                                process_count, process_index)


def test_global_mesh_axes():
    mesh = make_global_mesh(rep=2, sp=2)
    assert dict(mesh.shape) == {"data": 2, "rep": 2, "sp": 2}
    assert mesh.devices.size == len(jax.devices())


def test_single_process_helpers():
    initialize_distributed(num_processes=1)   # must be a no-op
    assert process_index() == 0
    assert process_count() == 1


def test_simulate_cli_roundtrip(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "claragenomicsanalysis_tpu.cli", "simulate",
         "--genome-length", "400", "--reads", "4", "--read-length", "150",
         "--seed", "3"],
        capture_output=True, text=True, check=True)
    lines = [l for l in out.stdout.splitlines() if l]
    assert sum(1 for l in lines if l.startswith(">")) == 4
    seqs = [l for l in lines if not l.startswith(">")]
    assert all(set(s) <= set("ACGT") for s in seqs)
    # deterministic for a fixed seed
    out2 = subprocess.run(
        [sys.executable, "-m", "claragenomicsanalysis_tpu.cli", "simulate",
         "--genome-length", "400", "--reads", "4", "--read-length", "150",
         "--seed", "3"],
        capture_output=True, text=True, check=True)
    assert out.stdout == out2.stdout


def test_align_cli_sp_auto_routing(tmp_path, monkeypatch, caplog):
    """`cli align -d 8` aligns a pair too large for (a shrunk) single
    device's memory with NO manual sp threshold — the ring-wavefront 'sp'
    path engages automatically and the output equals the single-device
    run."""
    import logging

    import numpy as np

    from claragenomicsanalysis_tpu.bench.samples import run_cli
    from claragenomicsanalysis_tpu.core import bufferplan
    from claragenomicsanalysis_tpu.utils.genomeutils import (
        generate_random_genome, mutate_sequence)

    rng = np.random.default_rng(5)
    a = generate_random_genome(1500, rng)
    b = mutate_sequence(a, 60, rng)
    (tmp_path / "q.fa").write_text(f">q\n{a}\n")
    (tmp_path / "t.fa").write_text(f">t\n{b}\n")
    # shrink the device so the 1.5 kb pair is "too large" for one device
    # (wall at 256 bases): the CLI must then route through the ring
    monkeypatch.setattr(bufferplan, "device_memory_bytes",
                        lambda: 256 * 4 * bufferplan.MYERS_LEVEL_BYTES_PER_BASE)
    caplog.set_level(logging.INFO, logger="claragenomicsanalysis_tpu")
    argv = ["align", str(tmp_path / "q.fa"), str(tmp_path / "t.fa"),
            "--algorithm", "hirschberg-myers"]

    sp = run_cli(argv + ["-d", "8"])
    assert "auto sp threshold 256" in caplog.text, caplog.text[-500:]
    assert "\t-1\t" not in sp and sp.startswith("q\tt\t")
    caplog.clear()
    single = run_cli(argv)
    assert "auto sp threshold" not in caplog.text
    assert sp == single
