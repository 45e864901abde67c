"""The port's yolov3 family (ResLayer, Darknet, YoloFpn, the yolov3 model)
and the model factories against the JAX package, on the CPU.

Same weights (the JAX module's `init` from a numpy seed, BN statistics
randomized, moved across with `state_dict_from_jax`) and the same inputs
(numpy seeds), float32. Tolerances: activations rtol 1e-4 / atol 1e-3 (the
frameworks sum convolutions in other orders; lrelu passes the differences
through at slope 1 or 0.1); serve detections at `assert_dets_match`'s
rtol 1e-4 / atol 1e-2 with the scores spread (`spread_scores`) and the
threshold in a gap of the JAX scores. The committed golden
(`tests/golden/yolov3_seed777.npz`) and the seeded init of the full model
are in `tests/test_torch_serve.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import assert_dets_match, gap_threshold, spread_scores
from test_torch_blocks import _nchw, _nhwc, _pair
from yolox_tpu.models import blocks as jb
from yolox_tpu.models.darknet import Darknet as JDarknet
from yolox_tpu.models.head import YoloxHead as JYoloxHead
from yolox_tpu.models.yolo_fpn import YoloFpn as JYoloFpn
from yolox_tpu.models.yolox import YoloxModule as JModule
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.models import blocks as tb
from yolox_tpu_torch.models.darknet import Darknet
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.weights import state_dict_to_jax
from yolox_tpu_torch.models.yolo_fpn import YoloFpn

RTOL, ATOL = 1e-4, 1e-3


def test_res_layer():
    jm = jb.ResLayer(32)
    params, tmod = _pair(jm, tb.ResLayer(32))
    x = np.random.default_rng(1).normal(size=(2, 9, 11, 32)).astype(
        np.float32)
    want = np.asarray(jm(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tmod.layer2.defer_requant_hbm and not tmod.layer1.defer_requant_hbm


@pytest.mark.parametrize("which", ["darknet", "yolo_fpn"])
def test_darknet_and_yolo_fpn_depth21(which):
    """Darknet-21 alone (all five feature maps) and under YoloFpn, 96 px."""
    if which == "darknet":
        feats = ("stem", "dark2", "dark3", "dark4", "dark5")
        jm, tm = JDarknet(21, out_features=feats), Darknet(21,
                                                           out_features=feats)
    else:
        jm, tm = JYoloFpn(depth=21), YoloFpn(depth=21)
    params, tmod = _pair(jm, tm, seed=2)
    img = np.random.default_rng(3).uniform(0, 255, (2, 96, 96, 3)).astype(
        np.float32)
    want = jax.jit(jm.__call__)(params, jnp.asarray(img))
    with torch.no_grad():
        got = tmod(torch.from_numpy(img))
    if which == "darknet":
        assert set(got) == set(want) == set(feats)
        pairs = [(got[k], want[k]) for k in feats]
    else:
        assert len(got) == 3
        pairs = list(zip(got, want))
    for g, w in pairs:
        # activations grow to ~1e2 through the stem's pixel-scale sums
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(w).max())
                                                   / 10))


def _yolov3_pair(depth=21, seed=5):
    """The JAX and port yolov3 models at `depth` with the same weights."""
    head = dict(in_channels=(128, 256, 512), act="lrelu")
    jm = JModule(JYoloFpn(depth=depth), JYoloxHead(80, 1.0, **head))
    tm = YoloxModule(YoloFpn(depth=depth), YoloxHead(80, 1.0, **head))
    tm.init_params(seed)
    return jm, tm


def test_yolov3_serve_matches_jax():
    """yolov3 (Darknet-21) through `serve` on uint8 frames: the port casts
    them to the model dtype for the 3x3 BaseConv stem, as JAX does."""
    jm, tm = _yolov3_pair()
    x = np.random.default_rng(4).integers(0, 256, (2, 96, 96, 3),
                                          dtype=np.uint8)
    spread_scores(tm, x)
    jm.params = jax.tree.map(jnp.asarray, state_dict_to_jax(tm.state_dict()))
    raw = jax.jit(lambda p, xx: jm.head.forward_raw(
        p["head"], jm.backbone(p["backbone"], xx)))(jm.params,
                                                     jnp.asarray(x, jnp.float32))
    out = np.asarray(raw[0])
    thr, gap = gap_threshold(out[..., 4] * out[..., 5:].max(-1), 0.02, 0.1)
    assert gap > 1e-3
    want = jax.jit(lambda p, xx: jm.serve(p, xx, conf_thre=thr, max_det=32))(
        jm.params, jnp.asarray(x))
    dets, valid = tm.serve(x, conf_thre=thr, max_det=32)
    assert int(valid.sum()) > 8, int(valid.sum())
    assert_dets_match(dets.numpy(), valid.numpy(), np.asarray(want[0]),
                      np.asarray(want[1]))
    # uint8 and float frames give the same outputs
    torch.testing.assert_close(tm(x), tm(x.astype(np.float32)), rtol=0,
                               atol=0)


def test_yolov3_get_model_defaults_to_cuda(monkeypatch):
    """`get_model()` places yolov3 on cuda and, with none present and no
    device given, raises; `device="cpu"` builds it there."""
    cfg = YoloxConfig.get_named_config("yolov3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.get_model()
    module = YoloxModule.from_config(cfg, device="cpu", dtype=torch.bfloat16)
    assert isinstance(module.backbone, YoloFpn)
    assert module.dtype == torch.bfloat16 and not module._focus_stem
    assert module.backbone.backbone.dark5[-3].conv2.act_name == "lrelu"


def test_build_factories(tmp_path, monkeypatch):
    from yolox_tpu_torch import models
    from yolox_tpu_torch.models import build
    from yolox_tpu_torch.models.weights import save_pth_state_dict

    for name in ("ResLayer", "Darknet", "YoloFpn", "iou_loss", "yolov3",
                 "create_yolox_model", "yolox_custom", "yolox_s"):
        assert name in models.__all__ and hasattr(models, name)
    m = build.create_yolox_model("yolox-nano", pretrained=False,
                                 num_classes=3, device="cpu")
    assert m.head.num_classes == 3 and m.device.type == "cpu"
    path = tmp_path / "nano.pth"
    custom_cfg = "yolox_tpu_torch.config:YoloxNano"
    save_pth_state_dict(m.state_dict(), path)
    with pytest.raises(ValueError, match="mismatch"):  # 3 classes in, 80 out
        build.yolox_custom(ckpt_path=str(path), exp_path=custom_cfg,
                           device="cpu")
    m80 = build.create_yolox_model("yolox-nano", pretrained=False,
                                   device="cpu")
    save_pth_state_dict(m80.state_dict(), path)
    custom = build.yolox_custom(ckpt_path=str(path), exp_path=custom_cfg,
                                device="cpu")
    for k, v in m80.state_dict().items():
        assert torch.equal(custom.state_dict()[k], v), k
    with pytest.raises(ValueError):
        build.create_yolox_model("yolox-q", device="cpu")
    with pytest.raises(ValueError):
        build.yolox_custom(exp_path="yolox_tpu_torch.config:no_such",
                           device="cpu")
    # each per-model factory names its model (yolov3 builds in
    # test_yolov3_get_model_defaults_to_cuda and the serve tests)
    monkeypatch.setattr(build, "create_yolox_model", lambda *a: a)
    assert build.yolov3(False, 5, "cpu") == ("yolov3", False, 5, "cpu")
    assert build.yolox_tiny() == ("yolox-tiny", True, 80, None)
