"""Micro-profile of the mapper's match stage on the accelerator.  Times
match_count's two sort-based searchsorteds and match_expand's fill paths
separately on realistic-scale index arrays (warm median of 5 runs ending
in block_until_ready), so an optimization targets the measured sub-part.

Usage: python scripts/profile_match.py [--elems 2_000_000]
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elems", type=int, default=2_000_000,
                    help="minimizer elements per index (100 Mbp chunk "
                         "scale)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from claragenomicsanalysis_tpu.bench.harness import (require_accelerator,
                                                         time_call)
    from claragenomicsanalysis_tpu.utils.compile_cache import \
        enable_compile_cache
    require_accelerator()
    enable_compile_cache()
    from claragenomicsanalysis_tpu.ops import map_ops
    from claragenomicsanalysis_tpu.utils.mathutils import round_up

    rng = np.random.default_rng(3)
    n = args.elems
    C = round_up(n, 1 << 18)

    def make_index(seed):
        r = np.random.default_rng(seed)
        # ~n/2 distinct hashed reps, sorted — matches build_index output
        rep = np.sort(r.integers(0, n // 2, C).astype(np.uint32))
        rep[n:] = 0xFFFFFFFF
        return {
            "rep": jnp.asarray(rep),
            "read_id": jnp.asarray(r.integers(0, 2500, C).astype(np.int32)),
            "pos": jnp.asarray(r.integers(0, 10_000, C).astype(np.int32)),
            "dir": jnp.asarray(r.integers(0, 2, C).astype(np.int32)),
            "n_elems": jnp.asarray(np.int32(n)),
        }

    qidx, tidx = make_index(1), make_index(2)
    KEYS = ("rep", "read_id", "pos", "dir", "n_elems")
    flat = tuple(qidx[k] for k in KEYS) + tuple(tidx[k] for k in KEYS)

    def undict(args):
        q = dict(zip(KEYS, args[:5]))
        t = dict(zip(KEYS, args[5:]))
        return q, t

    print(f"backend: {jax.default_backend()}; elems/index {n} (cap {C})",
          flush=True)

    lo, cum, total_d = map_ops.match_count(qidx, tidx)
    total = int(total_d)
    cap = min(1 << 24, max(1024, 1 << (max(total, 1) - 1).bit_length()))
    print(json.dumps({"phase": "anchors_total", "n": total, "cap": cap}),
          flush=True)

    def count_fn(*args):
        q, t = undict(args)
        return map_ops.match_count(q, t)[2]

    _, _, dt = time_call(jax.jit(count_fn), *flat)
    print(json.dumps({"phase": "match_count", "ms": round(dt * 1e3, 2)}),
          flush=True)

    def expand_fn(*args):
        q, t = undict(args)
        lo2, cum2, _ = map_ops.match_count(q, t)
        a = map_ops.match_expand(q, t, lo2, cum2, cap=cap, skip_self=True)
        return a["q_read"]

    _, _, dt2 = time_call(jax.jit(expand_fn), *flat)
    print(json.dumps({"phase": "count+expand", "ms": round(dt2 * 1e3, 2),
                      "expand_ms_est": round((dt2 - dt) * 1e3, 2)}),
          flush=True)


if __name__ == "__main__":
    main()
