"""The port's dev check lane (`scripts/torch_check.sh`): its lint half
(`scripts/torch_lint.py`, `scripts/lint_lite.py`'s checker over
`yolox_tpu_torch/`, `chip_smoke.py` and `scripts/torch_*.py`) finds
nothing in the port's files and does find a planted fault; the lane
names both halves."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _torch_lint():
    spec = importlib.util.spec_from_file_location(
        "torch_lint", REPO / "scripts" / "torch_lint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.smoke
def test_port_files_lint_clean():
    lint = _torch_lint()
    files = lint.port_files()
    assert REPO / "chip_smoke.py" in files
    assert REPO / "yolox_tpu_torch" / "models" / "yolox.py" in files
    assert REPO / "scripts" / "torch_lint.py" in files
    assert not any(p.name == "lint_lite.py" or "yolox_tpu/" in str(p)
                   for p in files)
    assert lint.findings() == []


def test_lint_finds_a_planted_fault(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n\n\ndef f(x=[]):\n    return f'no'\n")
    codes = sorted(code for _, code, _ in
                   _torch_lint().lint_lite().check_file(bad))
    assert codes == ["B006", "F401", "F541"]


def test_check_lane_runs_the_lint_then_the_port_smoke_lane():
    text = (REPO / "scripts" / "torch_check.sh").read_text()
    assert "ruff check yolox_tpu_torch chip_smoke.py scripts/torch_*.py" \
        in text
    assert "python scripts/torch_lint.py" in text
    assert "pytest tests/test_torch_*.py -m smoke" in text
    assert text.index("torch_lint.py") < text.index("-m smoke")
