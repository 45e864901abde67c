#!/bin/bash
# The port's dev check lane, beside scripts/check.sh (the JAX package's):
# lints yolox_tpu_torch/, chip_smoke.py and scripts/torch_*.py (real ruff
# when installed, else lint_lite.py's checker through
# scripts/torch_lint.py), then runs the port's <60 s smoke lane, the
# tests of tests/test_torch_*.py marked `smoke`.
set -e
cd "$(dirname "$0")/.."
if command -v ruff > /dev/null 2>&1; then
  ruff check yolox_tpu_torch chip_smoke.py scripts/torch_*.py
else
  python scripts/torch_lint.py
fi
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -m smoke -q
