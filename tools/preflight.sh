#!/bin/sh
# Release gate: the tier-1 tests on the CPU, then the chip smoke test.
#
#   sh tools/preflight.sh
#
# Step 2 needs a GPU: chip_smoke.py exits non-zero without one.
set -e
cd "$(dirname "$0")/.."

echo "== preflight 1/2: tier-1 tests (CPU, kernels in interpret mode) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow' -p xdist -n 6 --dist loadfile

echo "== preflight 2/2: chip smoke test (GPU) =="
python chip_smoke.py

echo "preflight PASSED"
