"""`scripts/torch_verify_pretrained.py` (the port's pretrained-weight
gate) on the CPU, with no network and no upstream tree.

The fixture (`chip_smoke.amplified_nano_pth`, `gate_images`; phase 15
runs the gate on the card with it) is a seeded nano checkpoint whose
prediction convs are amplified as in `tests/test_verify_pretrained.py`,
so that three synthetic images (filled rectangles, written as PNG) give
5 / 2 / 1 detections at 0.5 whose scores clear 0.5 by at least 0.011 and
each other by at least 0.0019. The expectations
come from the JAX package's `Yolox.from_pretrained` pipeline on the same
files, so leg 1 holds the port's whole pipeline (letterbox, forward,
postprocess) to JAX's at the gate's own tolerances. The gate must pass
(0), fail on perturbed boxes (1), report missing weights (2), report the
mAP leg "not-run" without data (2), and on a COCO set of those three
images (ground truth: JAX's detections) measure the same bf16 mAP as
JAX's `check_map` on the same `.pth` (45.033, equal to the gate's three
decimals), both "fail" against the zoo's 25.8.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)
from tests._torch_gate import coco_dir, jax_fixture

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
try:
    import torch_verify_pretrained as tvp
    import verify_pretrained as jvp
finally:
    sys.path.remove(str(SCRIPTS))

@pytest.fixture(scope="module")
def fixture_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gate")
    images, expectations = jax_fixture(tmp)
    assert [len(e["labels"]) for e in expectations["yolox_nano"]] == [5, 2, 1]
    exp_path = tmp / "expectations.json"
    exp_path.write_text(json.dumps(expectations))
    return tmp, images, exp_path, expectations


def _gate(argv):
    return tvp.main(argv + ["--device", "cpu"])


def test_gate_passes_on_the_jax_fixture(fixture_ckpt, tmp_path):
    tmp, images, exp_path, _ = fixture_ckpt
    out = tmp_path / "PARITY.json"
    rc = _gate(["--models", "yolox_nano", "--weights-dir", str(tmp),
                "--expectations", str(exp_path), "--images", *images,
                "--skip-map", "--skip-train", "--out", str(out)])
    report = json.loads(out.read_text())
    entry = report["models"]["yolox_nano"]
    assert rc == 0, entry
    assert entry["goldens"]["status"] == "pass"
    assert entry["goldens"]["images"] == 3
    assert entry["goldens"]["max_score_err"] <= tvp.SCORE_ATOL
    assert report["verdict"] == "parity-verified"
    assert report["tolerances"] == {"boxes": 1e-2, "scores": 1e-4,
                                    "map": 0.1}


def test_gate_fails_on_perturbed_expectations(fixture_ckpt, tmp_path):
    tmp, images, _, expectations = fixture_ckpt
    bad = json.loads(json.dumps(expectations))
    for img in bad["yolox_nano"]:
        for box in img["bboxes"]:
            box[0] += 0.5  # well past the 1e-2 box tolerance
    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(bad))
    out = tmp_path / "PARITY.json"
    rc = _gate(["--models", "yolox_nano", "--weights-dir", str(tmp),
                "--expectations", str(bad_path), "--images", *images,
                "--skip-map", "--skip-train", "--out", str(out)])
    assert rc == 1
    report = json.loads(out.read_text())
    assert report["models"]["yolox_nano"]["goldens"]["status"] == "fail"
    assert report["verdict"] == "PARITY-FAILED"
    # fewer images than expectation rows fails too
    rc = _gate(["--models", "yolox_nano", "--weights-dir", str(tmp),
                "--expectations", str(bad_path), "--images", images[0],
                "--skip-map", "--skip-train", "--out", str(out)])
    assert rc == 1
    assert "expectation rows" in json.loads(out.read_text())[
        "models"]["yolox_nano"]["goldens"]["detail"]


def test_gate_reports_missing_weights(tmp_path, monkeypatch):
    import urllib.request

    def no_net(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_net)
    monkeypatch.setenv("YOLOX_HOME", str(tmp_path / "home"))
    out = tmp_path / "PARITY.json"
    rc = _gate(["--models", "yolox_tiny", "--weights-dir", str(tmp_path),
                "--skip-map", "--skip-train", "--out", str(out)])
    assert rc == 2
    report = json.loads(out.read_text())
    assert report["models"]["yolox_tiny"]["weights"] == "missing"
    assert report["verdict"] == "incomplete-evidence"


def test_map_leg_not_run_without_data(fixture_ckpt, tmp_path):
    tmp, images, exp_path, _ = fixture_ckpt
    out = tmp_path / "PARITY.json"
    rc = _gate(["--models", "yolox_nano", "--weights-dir", str(tmp),
                "--expectations", str(exp_path), "--images", *images,
                "--data-dir", str(tmp_path / "nonexistent"),
                "--skip-train", "--out", str(out)])
    assert rc == 2
    report = json.loads(out.read_text())
    assert report["models"]["yolox_nano"]["map"]["status"] == "not-run"
    assert report["models"]["yolox_nano"]["goldens"]["status"] == "pass"
    np.testing.assert_allclose(
        report["models"]["yolox_nano"]["map"]["expected_map"], 25.8)


def test_train_leg_not_run_without_the_reference(fixture_ckpt, monkeypatch):
    import tests._reference_oracle as oracle

    monkeypatch.setattr(oracle, "reference_available", lambda: False)
    res = tvp.check_train_parity("yolox_nano", fixture_ckpt[0]
                                 / "yolox_nano.pth", device="cpu")
    assert res["status"] == "not-run"


def test_map_leg_equals_jax_check_map(fixture_ckpt, tmp_path, monkeypatch):
    tmp, images, _, expectations = fixture_ckpt
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "coco"
    coco_dir(data, images, expectations["yolox_nano"])
    ckpt = tmp / "yolox_nano.pth"
    got = tvp.check_map("yolox_nano", ckpt, data, device="cpu")
    want = jvp.check_map("yolox_nano", ckpt, data)
    assert got["status"] == want["status"] == "fail"
    assert got["expected_map"] == want["expected_map"] == 25.8
    assert got["tolerance"] == want["tolerance"] == 0.1
    assert got["measured_map"] > 0
    assert got["measured_map"] == want["measured_map"], (got, want)
    int8 = tvp.check_map("yolox_nano", ckpt, data, int8=True, device="cpu")
    assert int8["tolerance"] == 1.0 and int8["status"] == "fail"


def test_every_leg_reads_one_reference_tree(fixture_ckpt, tmp_path,
                                            monkeypatch):
    import shutil

    import tests._reference_oracle as oracle

    tmp, images, _, expectations = fixture_ckpt
    monkeypatch.delenv("YOLOX_REFERENCE", raising=False)
    assert tvp.reference_tree() == oracle.REFERENCE_PATH
    # an upstream tree with the fixture as its goldens (PNG bytes under
    # the reference's .jpg names) and no `yolox` package
    ref = tmp_path / "upstream"
    (ref / "tests" / "data").mkdir(parents=True)
    for i, path in enumerate(images):
        shutil.copy(path, ref / "tests" / "data" / f"{i:012d}.jpg")
    (ref / "tests" / "test_detections.py").write_text(
        f"DETECTIONS_DATA = {expectations!r}\n")
    monkeypatch.setenv("YOLOX_REFERENCE", str(ref))
    monkeypatch.setattr(oracle, "REFERENCE_PATH", oracle.REFERENCE_PATH)
    out = tmp_path / "PARITY.json"
    rc = _gate(["--models", "yolox_nano", "--weights-dir", str(tmp),
                "--skip-map", "--out", str(out)])
    entry = json.loads(out.read_text())["models"]["yolox_nano"]
    assert entry["goldens"]["status"] == "pass", entry
    assert entry["goldens"]["images"] == 3
    assert entry["train"] == {"status": "not-run",
                              "detail": "reference tree missing"}
    assert oracle.REFERENCE_PATH == ref
    assert rc == 2
