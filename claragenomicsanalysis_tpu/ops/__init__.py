"""Device ops: the XLA/Pallas compute kernels.

Each op family has a pure-XLA implementation that runs on any backend.  The
two DP hot paths also have a Pallas-Triton kernel for the GPU
(ops/myers_pallas.py, ops/nw_diag_pallas.py), bit-identical to its XLA twin
and asserted by tests; ops/banded.py selects between them.
"""
