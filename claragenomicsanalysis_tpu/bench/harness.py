"""Benchmark harness (reference: google-benchmark harnesses under
cudaaligner/benchmarks, cudapoa/benchmarks [U]).

Device timings end in `jax.block_until_ready`: JAX returns before the
device finishes, so a timing without it measures the enqueue.  The first
call compiles and is reported apart from the warm median.  Measurement
paths require an accelerator and never fall back to the CPU.
"""

import time

import jax
import numpy as np


def require_accelerator() -> jax.Device:
    """The first device, or SystemExit when JAX found only the CPU."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("no accelerator: JAX found only the CPU backend")
    return dev


def device_record() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def time_call(fn, *args, runs: int = 5):
    """-> (output, first-call seconds incl. compile, warm median seconds)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def bench_result(metric: str, value: float, unit: str, **detail) -> dict:
    return {"metric": metric, "value": float(value), "unit": unit,
            "device": device_record(), **detail}
