#!/usr/bin/env python
"""Lint the PyTorch port's files with `scripts/lint_lite.py`'s checker.

    python3 scripts/torch_lint.py

The port's files are `yolox_tpu_torch/`, `chip_smoke.py` and
`scripts/torch_*.py` (`port_files`); `lint_lite.py` lints the JAX
package's, and its rules (F401, F811, F541, E722, B006, W605) apply here
unchanged. Prints one line a finding and a count; exit status 1 if any.
`scripts/torch_check.sh` runs this where ruff is not installed.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def lint_lite():
    """`scripts/lint_lite.py` as a module (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "lint_lite", ROOT / "scripts" / "lint_lite.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_files():
    return (sorted((ROOT / "yolox_tpu_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py")))


def findings():
    """[(path relative to the repository, line, code, message)]."""
    check_file = lint_lite().check_file
    return [(str(p.relative_to(ROOT)), line, code, msg)
            for p in port_files() for line, code, msg in check_file(p)]


def main() -> int:
    found = findings()
    for path, line, code, msg in found:
        print(f"{path}:{line}: {code} {msg}")
    print(f"torch_lint: {len(found)} finding(s) in {len(port_files())} files")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
