"""Multi-host initialization — the N-host story (SURVEY.md §5.8).

The reference has NO distributed backend at all (its multi-GPU story is one
host thread per device, no inter-device communication).  Here the same
library code scales to N hosts: `jax.distributed.initialize` forms the
process group, `make_global_mesh` lays the ('data', 'rep', 'sp') axes over
ALL devices so that rep/sp ride ICI within a slice and only the data axis
crosses DCN, and every collective in parallel/shard.py and parallel/ring_nw.py
works unchanged (they only see the mesh).

Failure model (mirrors the reference's per-problem soft-status discipline at
cluster scale): jax.distributed is fail-fast — a lost host aborts the step —
and the all-vs-all manifest (parallel/manifest.py) makes the driver-level
restart resume from the last completed (query batch x target batch) pair.

Tested in-sandbox by tests/test_multihost_distributed.py: two spawned
processes form the process group over loopback and run a cross-process
shard_map psum + all-gather through Gloo on fake CPU devices.
"""

import numpy as np

import jax
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Form the multi-host process group (no-op when single-process).

    Arguments mirror jax.distributed.initialize; on clusters that JAX
    detects from the environment all three may be omitted."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_global_mesh(rep: int = 1, sp: int = 1) -> Mesh:
    """('data', 'rep', 'sp') mesh over ALL devices of every host.

    Device order keeps each host's devices contiguous on the data axis, so
    rep/sp collectives stay within a host's slice (ICI) and only data-axis
    traffic can cross DCN (SURVEY.md §5.8)."""
    devices = jax.devices()              # globally consistent order
    n = len(devices)
    if n % (rep * sp):
        raise ValueError(f"{n} devices not divisible by rep*sp={rep * sp}")
    arr = np.array(devices).reshape(n // (rep * sp), rep, sp)
    return Mesh(arr, ("data", "rep", "sp"))


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()
