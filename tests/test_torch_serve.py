"""The PyTorch port's serving path as a whole, on the CPU.

- The committed goldens (`tests/golden/*.npz`, made by the JAX package)
  at the golden test's tolerances: `valid` exact, `head_slice` at rtol
  1e-4 / atol 1e-3, detection rows at rtol 1e-4 / atol 1e-2. The seeded
  random models score every anchor near 1e-4, so rows whose golden scores
  agree to 1e-5 (relative) may swap places (`chip_smoke.assert_dets_match`,
  `GOLDEN_TIE`).
- Seeded init gives the JAX package's weights exactly.
- Batch padding and `stream` give `__call__`'s results.
- `.pth` round trip with strict key checking; config, preproc, the import
  rule and the device rule.
"""

import ast
import pathlib
import shutil
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    GOLDEN_TIE,
    assert_dets_match,
    assert_detections_match,
    anchor_scores,
    gap_threshold,
    spread_scores,
)
from yolox_tpu_torch import Yolox, YoloxConfig, YoloxModule, YoloxProcessor
from yolox_tpu_torch.models.weights import save_pth_state_dict
from yolox_tpu_torch.ops.nms import postprocess_device

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"

# (config, weight seed, input size, input seed): tests/test_golden_regression.py
SPECS = {"nano": ("yolox_nano", 1234, 416, 99), "s": ("yolox_s", 4321, 640, 98),
         "yolov3": ("yolov3", 777, 640, 97)}


def _module_and_input(name):
    cfg_name, wseed, size, xseed = SPECS[name]
    module = YoloxModule.from_config(YoloxConfig.get_named_config(cfg_name),
                                     rng_seed=wseed, device="cpu")
    x = np.random.default_rng(xseed).uniform(0, 255, (2, size, size, 3))
    return module, x.astype(np.float32)


@pytest.mark.parametrize("name", list(SPECS))
def test_inference_matches_committed_golden(name):
    want = np.load(GOLDEN / f"{name}_seed{SPECS[name][1]}.npz")
    module, x = _module_and_input(name)
    out = module(x)
    assert out.dtype == torch.float32 and out.shape[2] == 85
    np.testing.assert_allclose(out.numpy()[:, ::997, :], want["head_slice"],
                               rtol=1e-4, atol=1e-3)
    dets, valid = postprocess_device(out, 80, 1e-5, 0.65, False, 64)
    assert_dets_match(dets.numpy(), valid.numpy(), want["dets"],
                      want["valid"], tie=GOLDEN_TIE)


def test_serve_matches_committed_golden_both_stems():
    """The port has one stem; it must match the JAX serve graph with the
    space-to-depth stem on and off."""
    want = np.load(GOLDEN / "s_serve_seed4321.npz")
    module, x = _module_and_input("s")
    dets, valid = module.serve(x, conf_thre=1e-5, max_det=64)
    assert dets.shape == (2, 64, 7) and valid.dtype == torch.bool
    for tag in ("s2d_on", "s2d_off"):
        assert_dets_match(dets.numpy(), valid.numpy(), want[f"dets_{tag}"],
                          want[f"valid_{tag}"], tie=GOLDEN_TIE)


def test_dets_matcher_rejects_a_real_difference():
    want = np.load(GOLDEN / "s_serve_seed4321.npz")
    d, v = want["dets_s2d_on"].copy(), want["valid_s2d_on"]
    assert_dets_match(d, v, want["dets_s2d_on"], v)
    d[0, 3, 0] += 1.0
    with pytest.raises(AssertionError):
        assert_dets_match(d, v, want["dets_s2d_on"], v)
    d = want["dets_s2d_on"].copy()
    d[0, [0, 63]] = d[0, [63, 0]]  # scores 6e-5 apart (relative)
    with pytest.raises(AssertionError):
        assert_dets_match(d, v, want["dets_s2d_on"], v, tie=GOLDEN_TIE)


@pytest.mark.parametrize("name,seed", [("yolox_nano", 1234), ("yolox_s", 4321),
                                       ("yolov3", 777)])
def test_seeded_init_equals_jax(name, seed):
    from yolox_tpu import YoloxConfig as JConfig
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu.models.weights import pytree_to_state_dict

    want = pytree_to_state_dict(
        JModule.from_config(JConfig.get_named_config(name),
                            rng_seed=seed).params)
    got = YoloxModule.from_config(YoloxConfig.get_named_config(name),
                                  rng_seed=seed, device="cpu").state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def small_model():
    """yolox-nano at 256 px, with scores spread over (0, 0.6)."""
    cfg = YoloxConfig.get_named_config("yolox_nano")
    cfg.test_size = (256, 256)
    module = YoloxModule.from_config(cfg, rng_seed=3, device="cpu")
    spread_scores(module, np.random.default_rng(4).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8))
    return Yolox(module, YoloxProcessor(cfg))


def _frames(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


def test_padding_and_stream_match_call(small_model):
    frames = _frames(5, [(256, 256), (192, 256), (256, 160), (200, 120),
                         (256, 256)])
    batch = small_model.processor(frames)
    thr, gap = gap_threshold(anchor_scores(small_model.module, batch), 0.1,
                             0.3)
    assert gap > 1e-3
    one_by_one = [small_model([f], threshold=thr)[0] for f in frames]
    assert sum(len(d["labels"]) for d in one_by_one) > 20
    padded = small_model(frames[:3], threshold=thr)    # 3 -> 4 rows
    assert_detections_match(padded, one_by_one[:3])
    streamed = list(small_model.stream(iter(frames), threshold=thr,
                                       batch_size=2))  # 2, 2, 1
    assert_detections_match(streamed, one_by_one)
    with pytest.raises(ValueError):
        next(small_model.stream(frames, batch_size=0))


def test_call_on_a_batch_returns_decoded_rows(small_model):
    x = np.random.default_rng(6).uniform(0, 255, (2, 3, 256, 256)).astype(
        np.float32)  # NCHW goes in too
    out = small_model(x)
    assert out.shape == (2, 1344, 85) and out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), small_model.module(x.transpose(0, 2, 3, 1)).numpy(),
        rtol=1e-6, atol=1e-6)


def test_bf16_module_serves(small_model):
    sd = small_model.module.state_dict()
    cfg = small_model.processor.config
    m16 = YoloxModule.from_config(cfg, dtype=torch.bfloat16, device="cpu")
    m16.load_params(sd)
    assert m16.dtype == torch.bfloat16
    assert m16.state_dict()["backbone.backbone.stem.conv.bn.num_batches_tracked"].dtype == torch.int64
    x = np.random.default_rng(7).integers(0, 256, (2, 256, 256, 3),
                                          dtype=np.uint8)
    dets, valid = m16.serve(x, conf_thre=0.01, max_det=64)
    assert dets.dtype == torch.float32 and valid.any()
    out = m16(x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(ValueError):
        m16.cast_params(torch.float16)


def test_pth_round_trip_strict(tmp_path, monkeypatch, small_model):
    module = small_model.module
    cfg = small_model.processor.config
    path = tmp_path / "model.pth"
    save_pth_state_dict(module.state_dict(), path)
    loaded = YoloxModule.from_pretrained(path, config=cfg, device="cpu")
    for k, v in module.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # the JAX package reads the port's checkpoint with its own loader
    from yolox_tpu.models.weights import load_pth_params, nested_to_flat

    jflat = nested_to_flat(load_pth_params(path))
    assert set(jflat) == set(module.state_dict())
    # a named model comes from $YOLOX_HOME/weights; offline, the fetch of
    # a missing file fails and raises
    monkeypatch.setenv("YOLOX_HOME", str(tmp_path))
    monkeypatch.setattr(urllib.request, "urlretrieve", _offline)
    with pytest.raises(RuntimeError, match="none cached at"):
        YoloxModule.from_pretrained("yolox_nano", device="cpu")
    (tmp_path / "weights").mkdir(exist_ok=True)
    save_pth_state_dict(module.state_dict(), tmp_path / "weights" /
                        "yolox_nano.pth")
    model = Yolox.from_pretrained("yolox_nano", device="cpu")
    assert torch.equal(model.module.head.cls_preds[0].weight,
                       module.head.cls_preds[0].weight)
    bad = dict(module.state_dict())
    bad.pop("head.obj_preds.0.bias")
    with pytest.raises(ValueError, match="missing=\\['head.obj_preds.0.bias'\\]"):
        loaded.load_params(bad)
    with pytest.raises(ValueError, match="Unknown model"):
        YoloxModule.from_pretrained("yolox_q", device="cpu")


def _offline(url, filename):
    raise OSError(f"no network for {url}")


def test_from_pretrained_fetches_through_tmp_and_rename(tmp_path,
                                                        monkeypatch,
                                                        small_model):
    """A missing named checkpoint is fetched from the upstream release into
    `<file>.tmp` and renamed into place, then loads strict=True, as in the
    JAX package (`yolox_tpu/models/yolox.py::_cached_pretrained_weights`);
    the fetch is a copy of a local .pth here."""
    module = small_model.module
    src = tmp_path / "served.pth"
    save_pth_state_dict(module.state_dict(), src)
    fetched = []

    def fetch(url, filename):
        fetched.append((url, filename))
        shutil.copyfile(src, filename)

    home = tmp_path / "home"
    monkeypatch.setenv("YOLOX_HOME", str(home))
    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    model = Yolox.from_pretrained("yolox_nano", device="cpu")
    target = home / "weights" / "yolox_nano.pth"
    assert fetched == [(
        "https://github.com/Megvii-BaseDetection/YOLOX/releases/download/"
        "0.1.1rc0/yolox_nano.pth", f"{target}.tmp")]
    assert target.exists() and not pathlib.Path(f"{target}.tmp").exists()
    for k, v in module.state_dict().items():
        assert torch.equal(model.module.state_dict()[k], v), k
    # cached now: a second load does not fetch
    Yolox.from_pretrained("yolox_nano", device="cpu")
    assert len(fetched) == 1


def test_failed_fetch_raises_the_jax_message(tmp_path, monkeypatch):
    import yolox_tpu.models.yolox as jyolox

    monkeypatch.setenv("YOLOX_HOME", str(tmp_path))
    monkeypatch.setattr(jyolox, "HOME", tmp_path)
    monkeypatch.setattr(urllib.request, "urlretrieve", _offline)
    messages = []
    for cls in (YoloxModule, jyolox.YoloxModule):
        with pytest.raises(RuntimeError) as err:
            cls._cached_pretrained_weights("yolov3")
        assert isinstance(err.value.__cause__, OSError)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "yolox_darknet.pth" in messages[0]


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = YoloxConfig.get_named_config("yolox_nano")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YoloxModule.from_config(cfg)
    module = YoloxModule.from_config(cfg, device="cpu").train()
    assert module.training and module.device.type == "cpu"


def test_config_matches_jax():
    import dataclasses

    from yolox_tpu import YoloxConfig as JConfig

    for name in ("yolox_nano", "yolox_tiny", "yolox_s", "yolox_m", "yolox_l",
                 "yolox_x", "yolov3"):
        got = dataclasses.asdict(YoloxConfig.get_named_config(name))
        want = dataclasses.asdict(JConfig.get_named_config(name))
        assert got == want, name
    opts = {"num_classes": "3", "test_size": "(320, 256)", "seed": "7",
            "simota_candidates": "512", "data_dir": "/data/coco",
            "serve_stem_s2d": "False"}
    a, b = YoloxConfig.get_named_config("yolox_s"), JConfig.get_named_config(
        "yolox_s")
    a.update(dict(opts))
    b.update(dict(opts))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(AttributeError):
        a.update({"no_such_field": "1"})
    assert YoloxConfig.get_named_config("yolox-s") is not \
        YoloxConfig.get_named_config("yolox-s")
    with pytest.raises(NotImplementedError, match="later slice"):
        a.get_data_loader(4, is_distributed=True)  # data-parallel
    # yolov3 builds (Darknet-53 + YoloFpn + an lrelu head) and runs
    v3 = YoloxConfig.get_named_config("yolov3").get_model(device="cpu")
    out = v3(np.zeros((1, 64, 64, 3), np.uint8))
    assert out.shape == (1, 84, 85) and torch.isfinite(out).all()


@pytest.mark.parametrize("shape", [(480, 640), (640, 640), (333, 500)])
def test_preproc_matches_jax(shape):
    from yolox_tpu.ops.preproc import preproc as jpreproc
    from yolox_tpu_torch.ops.preproc import preproc

    img = np.random.default_rng(8).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    want, r_want = jpreproc(img, (640, 640))
    got, r = preproc(img, (640, 640))
    assert r == r_want and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got8, _ = preproc(img, (640, 640), dtype=np.uint8)
    assert got8.dtype == np.uint8
    np.testing.assert_array_equal(got8, want)


def test_processor_postprocess_matches_jax():
    from yolox_tpu import YoloxProcessor as JProcessor

    rng = np.random.default_rng(9)
    pred = np.zeros((2, 200, 85), np.float32)
    pred[..., :2] = rng.uniform(0, 416, (2, 200, 2))
    pred[..., 2:4] = rng.uniform(8, 80, (2, 200, 2))
    pred[..., 4:] = rng.uniform(0, 1, (2, 200, 81))
    images = _frames(10, [(300, 400), (416, 416)])
    got = YoloxProcessor("yolox_nano").postprocess(images, pred, 0.3)
    want = JProcessor("yolox_nano").postprocess(images, jnp.asarray(pred),
                                                0.3)
    assert_detections_match(got, want, rtol=1e-6, atol=1e-4)


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package."""
    files = sorted((REPO / "yolox_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "yolox_tpu"), \
                    f"{path.relative_to(REPO)} imports {name}"
