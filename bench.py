"""Aligner-kernel benchmark on the accelerator: the Myers bit-vector rows and
the banded NW that the product path selects (ops/banded.py: the Triton
kernels on a GPU), at B=1024 pairs of 512 bp with 4 % divergence.

Prints one JSON line per kernel — DP cell-updates/s from the warm median of
5 runs ending in block_until_ready, with the first (compiling) call apart —
then the secondary lines of scripts/bench_all.py.  Exits non-zero when JAX
finds no accelerator; it never falls back to the CPU.

Run: python bench.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B, L, BAND_RADIUS = 1024, 512, 64


def _batch(seed: int = 0):
    from claragenomicsanalysis_tpu.utils.genomeutils import (
        encode, generate_random_genome, mutate_sequence)
    rng = np.random.default_rng(seed)
    qs = [generate_random_genome(L, rng) for _ in range(B)]
    ts = [mutate_sequence(a, L // 25, rng)[:L] for a in qs]
    return (np.stack([encode(a, L) for a in qs]).astype(np.int8),
            np.array([len(a) for a in qs], np.int32),
            np.stack([encode(b, L) for b in ts]).astype(np.int8),
            np.array([len(b) for b in ts], np.int32))


def main() -> int:
    from claragenomicsanalysis_tpu.bench.harness import (bench_result,
                                                         require_accelerator,
                                                         time_call)
    from claragenomicsanalysis_tpu.ops import banded
    from claragenomicsanalysis_tpu.utils.compile_cache import \
        enable_compile_cache
    require_accelerator()
    enable_compile_cache()
    q, ql, t, tl = _batch()

    _, first, dt = time_call(banded.myers_bottom_row, q, ql, t, tl)
    print(json.dumps(bench_result(
        "Myers bit-vector DP cell-updates/s", B * L * L / dt / 1e9,
        "Gcells/s", warm_median_s=dt, first_call_s=first,
        kernel="pallas" if banded.on_gpu() else "xla")), flush=True)

    kind = banded.nw_kind("auto", BAND_RADIUS)
    _, first, dt = time_call(
        lambda *a: banded.banded_nw(*a, BAND_RADIUS)[0], q, ql, t, tl)
    cells = B * L * (2 * BAND_RADIUS + 1)
    print(json.dumps(bench_result(
        f"banded NW (r={BAND_RADIUS}) DP cell-updates/s", cells / dt / 1e9,
        "Gcells/s", warm_median_s=dt, first_call_s=first, kernel=kind)),
        flush=True)

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import bench_all
    for fn in (bench_all.bench_poa_corr, bench_all.bench_mapper):
        print(json.dumps(fn()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
