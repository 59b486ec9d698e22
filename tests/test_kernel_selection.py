"""Kernel selection (ops/banded.py) and the compile-cache placement
(utils/compile_cache.py): "auto" takes the XLA twins off the GPU, an
explicit kernel request the device cannot run raises, interpret mode is
reached only through interpret=True, and the traceback budgets follow the
selected kernel's layout."""

import os

import numpy as np
import pytest

import jax

from claragenomicsanalysis_tpu.align import myers_aligner
from claragenomicsanalysis_tpu.core import bufferplan
from claragenomicsanalysis_tpu.models.aligner import Aligner, create_aligner
from claragenomicsanalysis_tpu.ops import banded, nw_band
from claragenomicsanalysis_tpu.ops.nw_diag_pallas import MAX_RADIUS
from claragenomicsanalysis_tpu.utils import compile_cache
from claragenomicsanalysis_tpu.utils.genomeutils import encode


def _batch():
    pairs = [("ACGTACGTAA", "ACGTTCGTA"), ("GGGA", "GGA")]
    q = np.stack([encode(a, 16) for a, _ in pairs])
    t = np.stack([encode(b, 16) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], np.int32)
    tlen = np.array([len(b) for _, b in pairs], np.int32)
    return q, qlen, t, tlen


def test_auto_takes_xla_twins_on_cpu():
    assert jax.default_backend() == "cpu" and not banded.on_gpu()
    assert banded.nw_kind("auto", 64) == "xla"
    q, qlen, t, tlen = _batch()
    sc, tb = banded.banded_nw(q, qlen, t, tlen, 8)
    assert tb.kind == "xla"
    np.testing.assert_array_equal(
        np.asarray(sc), np.asarray(nw_band.banded_nw(q, qlen, t, tlen, 8)[0]))
    from claragenomicsanalysis_tpu.ops.myers import myers_bottom_row
    np.testing.assert_array_equal(
        np.asarray(banded.myers_bottom_row(q, qlen, t, tlen)[0]),
        np.asarray(myers_bottom_row(q, qlen, t, tlen)[0]))


def test_explicit_kernel_request_raises_off_gpu():
    q, qlen, t, tlen = _batch()
    with pytest.raises(RuntimeError, match="need a GPU"):
        banded.banded_nw(q, qlen, t, tlen, 8, "pallas")
    with pytest.raises(RuntimeError, match="need a GPU"):
        banded.myers_bottom_row(q, qlen, t, tlen, "pallas")
    aligner = create_aligner(16, 16, 2, band_radius=8, backend="pallas")
    aligner.add_alignment("ACGT", "ACGA")
    with pytest.raises(RuntimeError, match="need a GPU"):
        aligner.align_all()


@pytest.mark.parametrize("backend", ["palas", "pallas-row", "pallas-diag",
                                     "pallas2"])
def test_unknown_backend_strings_raise(backend):
    from claragenomicsanalysis_tpu.core.config import AlignerConfig
    with pytest.raises(ValueError, match="unknown kernel backend"):
        Aligner(AlignerConfig(16, 16, 2), backend=backend)


def test_interpret_selects_kernel_up_to_its_radius():
    assert banded.nw_kind("auto", MAX_RADIUS, interpret=True) == "pallas"
    assert banded.nw_kind("auto", MAX_RADIUS + 1, interpret=True) == "xla"
    assert banded.nw_kind("xla", 8, interpret=True) == "xla"
    with pytest.raises(ValueError, match="exceeds"):
        banded.nw_kind("pallas", MAX_RADIUS + 1, interpret=True)
    q, qlen, t, tlen = _batch()
    sc_k, tb_k = banded.banded_nw(q, qlen, t, tlen, 8, "pallas",
                                  interpret=True)
    sc_x, tb_x = banded.banded_nw(q, qlen, t, tlen, 8, "xla")
    assert tb_k.kind == "pallas"
    np.testing.assert_array_equal(np.asarray(sc_k), np.asarray(sc_x))
    assert (banded.traceback_paths(tb_k, qlen, tlen, 8)
            == banded.traceback_paths(tb_x, qlen, tlen, 8))


def test_traceback_budgets_follow_the_layout():
    """The kernel's 2-bit diagonal traceback keeps 5 kb spans at r=512 on
    the banded path; the XLA twin's row layout sends them to Hirschberg."""
    L, r = 8192, 512
    k = banded.tb_bytes_per_problem(L, L, r, "pallas")
    x = banded.tb_bytes_per_problem(L, L, r, "xla")
    assert k == (2 * L + 4) // 4 * (r + 1)
    assert x == L * nw_band.band_width(r)
    assert k <= myers_aligner.tb_budget("pallas")
    assert x > myers_aligner.tb_budget("xla")
    assert not myers_aligner._infeasible(L, L, r, "auto", interpret=True)
    assert myers_aligner._infeasible(L, L, r, "auto", interpret=False)


def test_myers_limit_derives_from_device_memory(monkeypatch):
    per = bufferplan.MYERS_LEVEL_BYTES_PER_BASE
    assert bufferplan.myers_max_query_len(4096 * 4 * per) == 4096
    monkeypatch.setattr(bufferplan, "device_memory_bytes",
                        lambda: 1024 * 4 * per)
    assert bufferplan.myers_max_query_len() == 1024
    assert bufferplan.device_memory_bytes() > 0


def test_dispatch_budget_derives_from_device_memory(monkeypatch):
    assert bufferplan.dispatch_bytes(64 << 20) == 1 << 20
    monkeypatch.setattr(bufferplan, "device_memory_bytes", lambda: 64 << 24)
    assert myers_aligner.tb_budget("pallas") == (1 << 24) // 8
    assert myers_aligner.tb_budget("xla") == myers_aligner.TB_BYTES_PER_PROBLEM
    # a 2 MiB-per-problem bucket is cut to the 8 problems the budget holds
    assert myers_aligner._chunk(8192, 8192, 512, 100, "auto", True) == 8


def test_anchor_capacity_derives_from_device_memory():
    per = bufferplan.ANCHOR_BYTES
    assert bufferplan.anchor_capacity((1 << 27) * per) == 1 << 27
    assert bufferplan.anchor_capacity(((1 << 27) + 5) * per) == 1 << 27
    assert bufferplan.anchor_capacity(per) == 1 << 20
    assert bufferplan.anchor_capacity(1 << 50) == 1 << 30


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.checkout_cache_dir() == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before
