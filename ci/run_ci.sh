#!/bin/sh
# CI pipeline (SURVEY.md L5 — the gpuCI analog, device-free):
#   1. build the native C++ components,
#   2. run the full test suite on the CPU backend with 8 fake devices
#      (exercises the distributed paths without hardware),
#   3. smoke the multi-device dryrun on 8 virtual devices and compile the
#      entry step.  The GPU proof is chip_smoke.py, run on a GPU machine.
# Usage: sh ci/run_ci.sh
set -e
cd "$(dirname "$0")/.."

echo "== native build =="
sh native/build.sh

echo "== tests (CPU backend, 8 fake devices) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "== multi-device dryrun (8 virtual devices) =="
XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
    python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

echo "== API docs current =="
python scripts/gen_api_docs.py --check

echo "== doc flag names match cli.py =="
python scripts/check_doc_flags.py

echo "== entry compile check =="
JAX_PLATFORMS=cpu python - <<'EOF'
import jax
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
print("entry() compiles")
EOF

echo "CI OK"
