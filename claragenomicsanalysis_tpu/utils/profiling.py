"""Profiling ranges (reference: CGA_NVTX_RANGE in common/utils/cudautils.hpp
[U]) — mapped to jax.profiler trace annotations, with a stage-timing registry
for the structured per-stage metrics described in SURVEY.md §5.5."""

import contextlib
import time
from collections import defaultdict

import jax

_STAGE_TOTALS: dict[str, float] = defaultdict(float)
_STAGE_COUNTS: dict[str, int] = defaultdict(int)

@contextlib.contextmanager
def trace_range(name: str):
    """NVTX-range analog: labels the profiler trace AND accumulates host
    wall time.  JAX dispatch is async, so a range's wall time is the host
    time spent in it, including any wait on the device it forces; device
    time per stage comes from the profiler trace (--profile-dir)."""
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    _STAGE_TOTALS[name] += dt
    _STAGE_COUNTS[name] += 1


def stage_timings() -> dict[str, dict[str, float]]:
    return {
        k: {"total_s": _STAGE_TOTALS[k], "count": _STAGE_COUNTS[k]}
        for k in sorted(_STAGE_TOTALS)
    }


def toplevel_total_s(timings: dict[str, dict[str, float]],
                     prefix: str = "") -> float:
    """Sum of the TOP-LEVEL ranges only: a range nested under another
    recorded range ('mapper.match.count' under 'mapper.match') is already
    inside its parent's total — summing every key double-counts it (the
    other)."""
    keys = [k for k in timings if k.startswith(prefix)]
    return sum(timings[k]["total_s"] for k in keys
               if not any(k != p and k.startswith(p + ".") for p in keys))


def reset_stage_timings() -> None:
    _STAGE_TOTALS.clear()
    _STAGE_COUNTS.clear()
