"""CPU NumPy oracles.

These are the executable specification of the package: each device kernel family
has a plain-NumPy twin here with IDENTICAL tie-break rules, and tests assert
bit-equality.  This reproduces the reference's test strategy of pairing every
CUDA device function with a CPU mirror (SURVEY.md §4.1; reference:
cudaaligner/src/needleman_wunsch_cpu.cpp [U], cudapoa/tests/basic_graph.hpp
[U]).
"""
