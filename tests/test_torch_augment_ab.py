"""`scripts/torch_augment_ab.py` and `scripts/torch_augment_outcome_ab.py`
(the port's host-against-device augmentation A/Bs) against the JAX
package's `scripts/augment_ab.py` and `augment_outcome_ab.py` on the CPU.
The JAX scripts are loaded from `scripts/` through importlib, as
`tests/test_trainer_e2e.py` does.

- Each script's config equals JAX's, field by field.
- `detect` on the same weights (a seeded module whose objectness and
  class logits are spread by `chip_smoke.spread_scores`, carried to JAX
  with `weights.state_dict_to_jax`) gives JAX's records: `n`, `cls` and
  `center_in_gt` exactly, `conf` within 1e-5 + 1e-4 |conf| (float32
  forwards summed in other orders), at a threshold in a gap of the
  port's scores near JAX's 0.1, so that both keep the same boxes.
- One `.pth`, which both packages read, gives the port's `run_one` AP50
  and AP50:95 equal to JAX's `run_one` within 1e-4 (both trainers replaced
  by one that writes that checkpoint). Its weights are spread as above,
  and the evaluation set's boxes are the model's own detections, moved a
  pixel or two, so that the APs lie well inside (0, 1).
- The host arm's first iteration: the port's loader gives JAX's batch,
  and the port's step gives the losses of JAX's `make_train_step` from
  the same parameters at rtol 1e-4 (`tests/test_torch_trainer.py`'s
  pattern). The device arms draw from other streams; they are held to
  each other in distribution (`tests/test_torch_augment_equivalence.py`).
- `main(["--epochs", "1", "--device", "cpu"])` runs both arms of each
  script; the printed keys are JAX's.
- The flags and their defaults are JAX's, plus `--device`; with no card
  and no `--device cpu` the scripts exit non-zero; importing them loads
  no `jax` and no `yolox_tpu` module.
- `YOLOX_RUN_AB=1` runs the full outcome A/B on the CPU with JAX's three
  bounds (`test_trainer_e2e.py::test_device_augment_training_outcome_ab`).
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types
from argparse import Namespace
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import AB_LOSS_GAP, AB_LOSS_MAX, gap_threshold, spread_scores
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)
from tests._synthetic_coco import build_learnable_coco, build_synthetic_coco

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jaa, taa = _load("augment_ab"), _load("torch_augment_ab")
jao, tao = _load("augment_outcome_ab"), _load("torch_augment_outcome_ab")


@pytest.fixture(scope="module")
def learnable(tmp_path_factory):
    return build_learnable_coco(tmp_path_factory.mktemp("lcoco"))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in fields(cfg)}


@pytest.mark.parametrize("dev,epochs", [(False, 50), (True, 7)])
def test_configs_equal_jax_s(tmp_path, dev, epochs):
    want = _fields(jaa.ABConfig("d", "o", dev, epochs))
    assert _fields(taa.ABConfig("d", "o", dev, epochs)) == want
    assert want["no_aug_epochs"] == max(2, epochs // 5)
    want = _fields(jao.make_config("d", "o", epochs * 3, dev))
    assert _fields(tao.make_config("d", "o", epochs * 3, dev)) == want
    assert want["no_aug_epochs"] == max(epochs * 3 // 10, 1)
    assert want["name"] == "aug_ab_" + ("device" if dev else "host")


def _spread_module(cfg, image, seed=3):
    """A seeded port module (CPU) with spread objectness and class
    scores on `image` (an HWC BGR array), in eval mode."""
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.data import ValTransform

    module = YoloxModule.from_config(cfg, rng_seed=seed, device="cpu")
    module.eval()
    x, _ = ValTransform()(image, None, cfg.test_size)
    spread_scores(module, torch.from_numpy(x)[None])
    return module


def _images(data_dir):
    from yolox_tpu_torch.data.datasets.coco import read_bgr

    ann = json.loads((Path(data_dir) / "annotations"
                      / "instances_train2017.json").read_text())
    return ann, [read_bgr(str(Path(data_dir) / "train2017"
                              / im["file_name"])) for im in ann["images"]]


def _scores(cfg, module, images):
    from yolox_tpu_torch.data import ValTransform

    x = np.stack([ValTransform()(im, None, cfg.test_size)[0]
                  for im in images])
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    return (out[..., 4] * out[..., 5:].max(-1).values).flatten().numpy()


def test_detect_equals_jax_on_the_same_weights(learnable, tmp_path):
    import jax
    import jax.numpy as jnp

    from yolox_tpu_torch.models.weights import state_dict_to_jax

    cfg = taa.ABConfig(learnable, str(tmp_path), False, 50)
    jcfg = jaa.ABConfig(learnable, str(tmp_path), False, 50)
    _, images = _images(learnable)
    module = _spread_module(cfg, images[0])
    conf, gap = gap_threshold(_scores(cfg, module, images[:6]), 0.07, 0.13)
    assert gap > 1e-3, gap
    params = jax.tree.map(jnp.asarray,
                          state_dict_to_jax(module.state_dict()))
    got = taa.detect(cfg, module, learnable, conf=conf)
    want = jaa.detect(jcfg, params, learnable, conf=conf)
    assert len(got) == len(want) == 6
    assert sum(r["n"] > 0 for r in got) >= 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for k in g:
            if k == "conf":
                assert abs(g[k] - w[k]) <= 1e-5 + 1e-4 * abs(w[k]), (g, w)
            else:
                assert g[k] == w[k], (k, g, w)


class _WritesCheckpoint:
    """A trainer whose `train` writes a given `.pth` where `run_one`
    loads it from, with a fixed latest loss."""

    def __init__(self, pth, out):
        self.pth, self.out = pth, out
        self.meter = {"total_loss": types.SimpleNamespace(latest=1.25)}
        self.device = torch.device("cpu")

    def train(self):
        os.makedirs(self.out, exist_ok=True)
        shutil.copy(self.pth, os.path.join(self.out, "latest_ckpt.pth"))


def _stub_trainer(monkeypatch, mod, pth):
    make = mod.make_config

    def make_config(data_dir, out_dir, epochs, device_aug):
        cfg = make(data_dir, out_dir, epochs, device_aug)
        cfg.get_trainer = lambda args: _WritesCheckpoint(
            pth, os.path.join(out_dir, cfg.name))
        return cfg

    monkeypatch.setattr(mod, "make_config", make_config)


def _own_detection_set(cfg, module, data_dir, rng):
    """Rewrite `data_dir`'s annotations: per image the module's top three
    detections (conf 0.05) in image pixels, each side moved by N(0, 1.5)
    px, with their classes."""
    from yolox_tpu_torch.data import ValTransform
    from yolox_tpu_torch.ops.nms import postprocess_device

    ann, images = _images(data_dir)
    cats = sorted(c["id"] for c in ann["categories"])
    ann["annotations"] = []
    for im, img in zip(ann["images"], images):
        x, _ = ValTransform()(img, None, cfg.test_size)
        with torch.no_grad():
            dets, valid = postprocess_device(
                module(torch.from_numpy(x)[None]), cfg.num_classes,
                conf_thre=cfg.test_conf, nms_thre=cfg.nmsthre)
        rows = dets[0][valid[0]][:3].numpy().astype(np.float64)
        assert len(rows) == 3
        r = min(cfg.test_size[0] / im["height"], cfg.test_size[1] / im["width"])
        for row in rows:
            x1, y1, x2, y2 = row[:4] / r + rng.normal(0, 1.5, 4)
            ann["annotations"].append({
                "id": len(ann["annotations"]) + 1, "image_id": im["id"],
                "category_id": cats[int(row[6])],
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
    (Path(data_dir) / "annotations" / "instances_train2017.json").write_text(
        json.dumps(ann))


def test_outcome_evaluation_equals_jax_on_one_pth(tmp_path, monkeypatch):
    data_dir = build_synthetic_coco(tmp_path / "data")
    cfg = tao.make_config(data_dir, str(tmp_path), 150, False)
    _, images = _images(data_dir)
    module = _spread_module(cfg, images[0], seed=0)
    _own_detection_set(cfg, module, data_dir, np.random.default_rng(0))
    pth = str(tmp_path / "shared.pth")
    torch.save({"model": module.state_dict()}, pth)
    _stub_trainer(monkeypatch, tao, pth)
    _stub_trainer(monkeypatch, jao, pth)
    got = tao.run_one(data_dir, str(tmp_path / "t"), 150, False,
                      device="cpu")
    want = jao.run_one(data_dir, str(tmp_path / "j"), 150, False)
    assert got.keys() == want.keys()
    assert got["final_loss"] == want["final_loss"] == 1.25
    assert got["device_augment"] is want["device_augment"] is False
    for k in ("ap50", "ap50_95"):
        assert abs(got[k] - want[k]) <= 1e-4, (got, want)
    assert 0.3 < got["ap50_95"] < got["ap50"] < 1.0, got


def _args():
    return Namespace(batch_size=4, fp16=False, cache=None,
                     logger="tensorboard", ckpt=None, resume=False,
                     start_epoch=None, name="run", device="cpu")


def test_first_host_iteration_losses_equal_jax_s(learnable, tmp_path):
    import jax.numpy as jnp

    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu.core import init_train_state as j_init
    from yolox_tpu.core import make_train_step as j_make
    from yolox_tpu_torch.models.weights import state_dict_from_jax

    jcfg = jaa.ABConfig(learnable, str(tmp_path / "j"), False, 50)
    cfg = taa.ABConfig(learnable, str(tmp_path / "t"), False, 50)
    jmodule = JModule.from_config(jcfg, rng_seed=jcfg.seed)
    port_model = cfg.get_model

    def from_jax(rng_seed=0, device=None):
        module = port_model(rng_seed=rng_seed, device=device)
        module.load_state_dict(state_dict_from_jax(jmodule.params))
        return module

    cfg.get_model = from_jax
    trainer = cfg.get_trainer(_args())
    trainer.before_train()
    assert not trainer.no_aug and not trainer._device_augment
    batch = trainer.prefetcher._next
    jloader = jcfg.get_data_loader(4)
    jimgs, jtargets, _, _ = next(iter(jloader))
    jloader.close()
    np.testing.assert_array_equal(batch[0].numpy(), jimgs)
    np.testing.assert_array_equal(batch[1].numpy(), jtargets)

    trainer.iter = 0
    trainer.train_one_iter()
    got = {k: trainer.meter[k].latest for k in
           ("total_loss", "iou_loss", "conf_loss", "cls_loss", "l1_loss",
            "num_fg")}
    lr = trainer.meter["lr"].latest
    trainer.after_train()

    step = j_make(jmodule, jcfg.num_classes, use_l1=False)
    _, want = step(j_init(jmodule.params), jnp.asarray(jimgs),
                   jnp.asarray(jtargets), jnp.float32(lr))
    for k, v in got.items():
        np.testing.assert_allclose(v, float(want[k]), rtol=1e-4, err_msg=k)
    assert got["num_fg"] > 0


def _jax_result_keys(monkeypatch, tmp_path):
    """The keys of JAX's `run_arm` result, its trainer and `detect`
    replaced (nothing trains or compiles)."""
    meter = {"total_loss": types.SimpleNamespace(global_avg=1.0, avg=1.0)}
    trainer = types.SimpleNamespace(train=lambda: None, meter=meter,
                                    _eval_params=lambda: None)
    monkeypatch.setattr(jaa.ABConfig, "get_trainer",
                        lambda self, args: trainer)
    monkeypatch.setattr(jaa, "detect", lambda *a, **k: [])
    monkeypatch.setattr(jaa.tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path / prefix))
    return jaa.run_arm(False, "d", 1).keys()


def test_augment_ab_main_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(taa.tempfile, "tempdir", str(tmp_path))
    results = taa.main(["--epochs", "1", "--device", "cpu"])
    printed = [json.loads(line.split(" ", 1)[1])
               for line in capsys.readouterr().out.splitlines()
               if line.startswith("RESULT ")]
    assert printed == results
    assert [r["dev"] for r in results] == [False, True]
    keys = _jax_result_keys(monkeypatch, tmp_path)
    for r in results:
        assert r.keys() == keys
        assert np.isfinite(r["run_avg_loss"]) and np.isfinite(r["final_loss"])
        assert len(r["dets"]) == 6
        for d in r["dets"]:
            assert set(d) == {"img", "n", "gt_cls"} | (
                {"cls", "conf", "center_in_gt"} if d["n"] else set())


def test_outcome_main_on_the_cpu(monkeypatch, tmp_path, capsys):
    report = tao.main(["--epochs", "1", "--device", "cpu", "--out",
                       str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert json.loads(out.split("AUG_OUTCOME_AB ", 1)[1]) == report

    def run_one(data_dir, out_dir, epochs, device_aug):
        return {"device_augment": device_aug, "final_loss": 1.0,
                "ap50_95": 0.0, "ap50": 0.0}

    monkeypatch.setattr(jao, "run_one", run_one)
    monkeypatch.setattr(sys, "argv", ["augment_outcome_ab.py", "--epochs",
                                      "1", "--out", str(tmp_path / "jax")])
    jao.main()
    want = json.loads(capsys.readouterr().out.split("AUG_OUTCOME_AB ", 1)[1])
    assert report.keys() == want.keys()
    for arm in ("host", "device"):
        assert report[arm].keys() == want[arm].keys()
        assert np.isfinite(report[arm]["final_loss"])
    assert report["epochs"] == 1
    assert [report["host"]["device_augment"],
            report["device"]["device_augment"]] == [False, True]


class _Parsed(Exception):
    pass


def _parsed(monkeypatch, main, argv):
    """The namespace `main` parses from `argv`; nothing after it runs."""
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["ns"] = parse(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    if argv is None:
        monkeypatch.setattr(sys, "argv", ["script"])
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    return vars(seen["ns"])


def test_flags_are_jax_flags_plus_device(monkeypatch, tmp_path):
    got = _parsed(monkeypatch, taa.main, [])
    assert got.pop("device") is None
    assert got == _parsed(monkeypatch, jaa.main, []) == \
        {"epochs": 50, "which": "both"}
    argv = ["--epochs", "3", "--which", "dev"]
    assert _parsed(monkeypatch, taa.main, argv + ["--device", "cpu"]) == \
        {**_parsed(monkeypatch, jaa.main, argv), "device": "cpu"}

    got = _parsed(monkeypatch, tao.main, [])
    assert got.pop("device") is None
    want = _parsed(monkeypatch, lambda argv: jao.main(), None)
    assert want == {"epochs": 150, "out": "/tmp/aug_ab"}
    # the port's default follows TMPDIR (JAX's is the literal /tmp path)
    import tempfile

    assert got == {**want, "out": os.path.join(tempfile.gettempdir(),
                                               "aug_ab")}
    for main in (taa.main, tao.main):
        with pytest.raises(SystemExit):
            main(["--device", "tpu"])


@pytest.mark.parametrize("script", ["torch_augment_ab",
                                    "torch_augment_outcome_ab"])
def test_no_card_and_no_cpu_flag_exits_non_zero(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    run = subprocess.run([sys.executable, str(SCRIPTS / f"{script}.py"),
                          "--epochs", "1"], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=120)
    assert run.returncode != 0
    assert "device='cpu'" in run.stderr, run.stderr[-2000:]
    assert "RESULT" not in run.stdout and "AUG_OUTCOME_AB" not in run.stdout


def test_importing_the_scripts_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(SCRIPTS)!r})\n"
        "import torch_augment_ab as taa, torch_augment_outcome_ab as tao\n"
        "taa.ABConfig('d', 'o', True, 10)\n"
        "tao.make_config('d', 'o', 10, True)\n"
        "import yolox_tpu_torch.data, yolox_tpu_torch.ops.nms\n"
        "import yolox_tpu_torch.utils.checkpoint, _synthetic_coco\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'yolox_tpu'\n"
        "             or m.startswith('yolox_tpu.'))\n"
        "print('BAD', bad)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "BAD []" in run.stdout, run.stdout


def test_phase_17_counts_augmented_steps_and_launches():
    """`chip_smoke.aug_steps` is the Trainer's rule (the mosaic closes at
    epoch index max_epoch - no_aug_epochs - 1), and `check_ab_iterations`
    fails on a wrong count or a K5 launch outside an augmented step."""
    from chip_smoke import aug_steps, check_ab_iterations

    assert aug_steps(50, 10, 4) == 156 and aug_steps(50, 5, 3) == 132
    assert aug_steps(1, 2, 4) == 0
    zero = dict.fromkeys(("shear_xy", "shear_x", "reduce_sums",
                          "main_1x1"), 0)

    def rec(aug, **n):
        return {"aug": aug, "l1": not aug, "loss": 1.0,
                "launches": {**zero, **n}}

    good = [rec(True, shear_xy=1)] * 3 + [rec(False)] * 2
    check_ab_iterations("dev", good, 3, on_card=True)
    with pytest.raises(AssertionError, match="augmented steps"):
        check_ab_iterations("dev", good, 4, on_card=True)
    for bad in ([rec(True)], [rec(False, shear_xy=1)],
                [rec(True, shear_xy=1, shear_x=1)],
                [rec(True, shear_xy=1, main_1x1=43)]):
        with pytest.raises(AssertionError, match="launched"):
            check_ab_iterations("dev", bad, sum(r["aug"] for r in bad),
                                on_card=True)
    check_ab_iterations("dev", [rec(True)], 1, on_card=False)


@pytest.mark.skipif(not os.environ.get("YOLOX_RUN_AB"),
                    reason="the outcome-level augment A/B trains 2 x 200 "
                           "steps (~40 s an arm on an 8-core CPU host) - set "
                           "YOLOX_RUN_AB=1")
def test_device_augment_training_outcome_ab():
    host, dev = taa.main(["--which", "both", "--device", "cpu"])
    for arm in (host, dev):
        assert arm["run_avg_loss"] < AB_LOSS_MAX, arm   # converged (~12.5)
        assert arm["confident_correct"] >= 1, arm
    rel = (abs(host["run_avg_loss"] - dev["run_avg_loss"])
           / host["run_avg_loss"])
    assert rel < AB_LOSS_GAP, (host["run_avg_loss"], dev["run_avg_loss"])
