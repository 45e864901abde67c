"""`scripts/torch_eval_at_scale.py` (the port's evaluation lane at scale)
against the JAX package's `scripts/eval_at_scale.py` on the CPU, at a
few images:

- `build_dataset` writes the same annotation file and the same JPEG
  bytes as JAX's for the same seed;
- the script's random-weight checkpoint holds the JAX package's seeded
  weights;
- the script runs `yolox-tpu-torch eval` with nano on 8 images of the
  set it builds (B 4, bf16, conf 2e-5): rc 0 and every field of the
  report;
- on a set whose ground truth gives a mAP well above zero (the gate's
  amplified nano, its three images, JAX's detections as the ground
  truth) both scripts measure the same 12 COCO statistics (within 1e-6,
  as `tests/test_torch_cli.py` holds the two `eval` commands) from the
  same confident detections. On random weights every statistic is 0 and
  the count is capped at 1 024 an image, whatever the evaluation does.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)
from tests._torch_gate import coco_dir, jax_fixture

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
try:
    import eval_at_scale as jeas
    import torch_eval_at_scale as teas
finally:
    sys.path.remove(str(SCRIPTS))

FIELDS = ("images", "model", "batch", "wall_s", "img_per_s_end_to_end",
          "peak_host_rss_gb", "device_peak_bytes", "rc")


def test_build_dataset_writes_jax_files(tmp_path):
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jeas.build_dataset(jroot, 12, seed=3)
    teas.build_dataset(troot, 12, seed=3)
    ann = "annotations/instances_val2017.json"
    assert (troot / ann).read_bytes() == (jroot / ann).read_bytes()
    names = sorted(p.name for p in (jroot / "val2017").iterdir())
    assert names == sorted(p.name for p in (troot / "val2017").iterdir())
    assert len(names) == 12
    for name in names:
        assert ((troot / "val2017" / name).read_bytes()
                == (jroot / "val2017" / name).read_bytes()), name
    assert (troot / ".complete_12").exists()
    data = json.loads((troot / ann).read_text())
    ids = sorted(c["id"] for c in data["categories"])
    assert len(ids) == 80 and 9 not in ids and ids[-1] == 89
    assert data["categories"][0]["name"] == "person"
    # cached: a second call writes nothing
    (troot / "val2017" / names[0]).write_bytes(b"")
    teas.build_dataset(troot, 12, seed=3)
    assert (troot / "val2017" / names[0]).read_bytes() == b""


def test_random_checkpoint_holds_the_seeded_weights(tmp_path):
    from yolox_tpu import YoloxConfig as JConfig
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu_torch.models.weights import (
        load_pth_state_dict,
        nested_to_flat,
        state_dict_to_jax,
    )

    path = teas.random_checkpoint("nano", tmp_path)
    assert path == tmp_path / "random_nano.pth"
    got = nested_to_flat(state_dict_to_jax(load_pth_state_dict(path)))
    want = nested_to_flat(JModule.from_config(
        JConfig.get_named_config("yolox_nano"), rng_seed=0).params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_eval_at_scale_report_on_the_built_set(tmp_path):
    report = teas.run(images=8, model="nano", batch=4, root=tmp_path / "set",
                      ckpt_dir=tmp_path / "ckpt_torch", device="cpu")
    for key in FIELDS:
        assert key in report, key
    assert report["rc"] == 0 and report["images"] == 8
    assert report["device"] == "cpu" and report["device_peak_bytes"] is None
    assert report["images_with_detections"] == 8
    assert report["image_ids"] == list(range(8))
    assert report["detections"] > 8 and report["matcher"] == "native"
    assert len(report["stats"]) == 12
    assert set(report["stages_s"]) == {"start_up", "inference_loop",
                                       "cocoeval", "tables_and_exit"}
    assert (tmp_path / "ckpt_torch" / "yolox_nano"
            / "eval_log.txt").exists()


def _confident(cols, score=0.5):
    keep = cols["score"] >= score
    return {k: v[keep] for k, v in cols.items()}


def test_eval_at_scale_matches_jax(tmp_path, monkeypatch, capsys):
    """Both scripts on one set whose ground truth gives a mAP well above
    zero: the amplified nano of the gate's fixture (as the random
    checkpoint both scripts reuse) on its three images, the ground truth
    JAX's detections. The 12 statistics agree, and so do the confident
    detections handed to COCOeval (image, box, score, category)."""
    import yolox_tpu.evaluators.coco_evaluator as jce
    from yolox_tpu.evaluators.cocoeval import COCOeval as JCOCOeval

    from yolox_tpu_torch.evaluators import CocoEvaluator
    from yolox_tpu_torch.evaluators.cocoeval import COCOeval

    monkeypatch.chdir(tmp_path)   # JAX's command writes its log under ./out
    fix = tmp_path / "fixture"
    fix.mkdir()
    images, expectations = jax_fixture(fix)
    root = tmp_path / "set"
    coco_dir(root, images, expectations["yolox_nano"])
    (root / ".complete_3").touch()  # both scripts take the set as built
    for side in ("torch", "jax"):
        (tmp_path / f"ckpt_{side}").mkdir()
        shutil.copy(fix / "yolox_nano.pth",
                    tmp_path / f"ckpt_{side}" / "random_nano.pth")

    got, want = {}, {}
    for cls, rec in ((COCOeval, got), (JCOCOeval, want)):
        summarize = cls.summarize

        def record_summary(self, summarize=summarize, rec=rec):
            summarize(self)
            rec["stats"] = [float(s) for s in self.stats]

        monkeypatch.setattr(cls, "summarize", record_summary)
    for cls, rec in ((CocoEvaluator, got), (jce.CocoEvaluator, want)):
        predict = cls.evaluate_prediction

        def record_prediction(self, data_dict, statistics, predict=predict,
                              rec=rec):
            rec["columns"] = {k: np.asarray(v) for k, v in data_dict.items()}
            return predict(self, data_dict, statistics)

        monkeypatch.setattr(cls, "evaluate_prediction", record_prediction)

    report = teas.run(images=3, model="nano", batch=2, root=root,
                      ckpt_dir=tmp_path / "ckpt_torch", device="cpu")
    assert report["rc"] == 0 and report["image_ids"] == [0, 1, 2]
    assert report["stats"] == got["stats"]
    monkeypatch.setattr(sys, "argv", [
        "eval_at_scale.py", "--images", "3", "--model", "nano", "--batch",
        "2", "--root", str(root), "--ckpt-dir", str(tmp_path / "ckpt_jax")])
    jeas.main()
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("EVAL_AT_SCALE ")][-1]
    jreport = json.loads(line.split(" ", 1)[1])
    assert jreport["rc"] == 0
    assert set(FIELDS) <= set(jreport)

    assert got["stats"][0] > 0.3, got["stats"]
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=0,
                               atol=1e-6)
    assert report["detections"] == len(want["columns"]["score"])
    # the confident detections, which decide the mAP here, paired one to
    # one by box (IoU > 0.9 in the same image). In bf16 a score steps by
    # 2^-7 near 1, and the tail of near-ties at the low threshold may
    # order differently; one pair here has two classes within 0.01 of
    # each other, which bf16 ranks the other way round
    g, w = _confident(got["columns"]), _confident(want["columns"])
    assert len(w["score"]) == len(g["score"]) >= 8
    used, flips = set(), 0
    for i in range(len(w["score"])):
        ious = [(_iou_xywh(w["bbox"][i], g["bbox"][j]), j)
                for j in range(len(g["score"]))
                if j not in used and g["image_id"][j] == w["image_id"][i]]
        iou, j = max(ious, default=(0.0, None))
        assert iou > 0.9, (i, w["bbox"][i])
        used.add(j)
        assert abs(g["score"][j] - w["score"][i]) <= 2e-2
        flips += int(g["category_id"][j] != w["category_id"][i])
    assert flips <= 1


def _iou_xywh(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2 = min(a[0] + a[2], b[0] + b[2])
    y2 = min(a[1] + a[3], b[1] + b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def test_flags_are_jax_flags_plus_device(monkeypatch, capsys):
    seen = {}

    def fake_run(*args):
        seen["args"] = args
        return {"rc": 0, "image_ids": [0]}

    monkeypatch.setattr(teas, "run", fake_run)
    assert teas.main(["--images", "20", "--model", "nano", "--batch", "8",
                      "--root", "r", "--conf", "0.1", "--int8",
                      "--ckpt-dir", "c", "--device", "cpu"]) == 0
    assert seen["args"] == (20, "nano", 8, "r", 0.1, True, "c", "cpu")
    assert capsys.readouterr().out.startswith("EVAL_AT_SCALE {")


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teas.run(images=1, root=tmp_path / "r", ckpt_dir=tmp_path / "c")
    assert not (tmp_path / "r").exists()
