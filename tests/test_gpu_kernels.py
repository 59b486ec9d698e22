"""The Triton kernels compiled for the card (no interpret mode) against
their XLA twins and the cpu/ oracles — the checks chip_smoke.py's kernel
phase runs at full width, here at small widths.  Marked `gpu`: the `gpu`
fixture skips them where JAX finds no GPU.

Run on a GPU machine:  JAX_PLATFORMS=cuda python -m pytest tests -m gpu"""

import pytest

from claragenomicsanalysis_tpu.bench.kernel_checks import (check_banded,
                                                           check_myers)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("B,L", [(64, 96), (40, 1100)])
def test_myers_kernel_on_card(gpu, B, L):
    assert check_myers(B, L, n_oracle=2, runs=1)["equal"]


@pytest.mark.parametrize("B,L,r", [(64, 128, 1), (64, 256, 16),
                                   (16, 512, 64), (4, 1024, 300)])
def test_banded_kernel_on_card(gpu, B, L, r):
    assert check_banded(B, L, r, n_oracle=2, runs=1)["equal"]
