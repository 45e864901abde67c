"""The public names of the port's `ops` package against the JAX package's
`yolox_tpu/ops` on the CPU: the nine exported names, the box helpers
(`xyxy2xywh`, `bboxes_iou` on xyxy and cxcywh boxes, `filter_box`,
`matrix_iou`) on seeded boxes, and `postprocess_fused` (the
concatenated raw-head postprocess) bit-equal in float32 to
`postprocess_device` on the decoded output and to `serve`, and equal to
JAX's `postprocess_fused` on the same raw outputs. Box results are
compared exactly: each is the same sequence of float32 operations in
both packages. The import check runs in a subprocess: importing the
port's `ops` and the three harness scripts loads no module of JAX or of
the JAX package.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import yolox_tpu.ops as jops
import yolox_tpu_torch.ops as tops
from chip_smoke import assert_dets_match
from yolox_tpu.ops import boxes as jboxes
from yolox_tpu.ops import nms as jnms
from yolox_tpu_torch.ops import boxes as tboxes
from yolox_tpu_torch.ops.nms import postprocess_device, postprocess_fused
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

REPO = Path(__file__).resolve().parent.parent


def _boxes(rng, n, lo=0.0, hi=200.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(1.0, 80.0, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_ops_exports_the_jax_names():
    assert tops.__all__ == jops.__all__
    assert len(tops.__all__) == 9
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


def test_xyxy2xywh_and_bboxes_iou_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 37), _boxes(rng, 23)
    b[:3] = a[:3]                      # identical boxes
    b[3] = [a[4, 2], a[4, 1], a[4, 2] + 5, a[4, 3]]   # touching
    np.testing.assert_array_equal(
        tboxes.xyxy2xywh(torch.from_numpy(a)).numpy(),
        np.asarray(jboxes.xyxy2xywh(jnp.asarray(a))))
    np.testing.assert_array_equal(
        tboxes.bboxes_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.bboxes_iou(jnp.asarray(a), jnp.asarray(b))))
    ca = rng.uniform(10, 200, (19, 4)).astype(np.float32)
    cb = rng.uniform(10, 200, (11, 4)).astype(np.float32)
    got = tboxes.bboxes_iou(torch.from_numpy(ca), torch.from_numpy(cb),
                            xyxy=False).numpy()
    want = np.asarray(jboxes.bboxes_iou(jnp.asarray(ca), jnp.asarray(cb),
                                        xyxy=False))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any() and (got == 0).any()


def test_filter_box_and_matrix_iou_match_jax():
    rng = np.random.default_rng(1)
    out = np.concatenate([_boxes(rng, 64), rng.uniform(0, 1, (64, 3))],
                         1).astype(np.float32)
    for scale_range in ((8.0, 40.0), (0.0, 1e4), (30.0, 31.0)):
        got = tboxes.filter_box(torch.from_numpy(out), scale_range).numpy()
        want = np.asarray(jboxes.filter_box(jnp.asarray(out), scale_range))
        np.testing.assert_array_equal(got, want)
    assert 0 < len(tboxes.filter_box(torch.from_numpy(out),
                                     (8.0, 40.0))) < 64
    a, b = _boxes(rng, 13).astype(np.float64), _boxes(rng, 9)
    b[0] = a[0]
    np.testing.assert_array_equal(tboxes.matrix_iou(a, b),
                                  jboxes.matrix_iou(a, b))


def test_postprocess_fused_bit_equal_to_decoded_postprocess_and_serve():
    """Select-then-decode on the raw outputs is decode-then-select in
    float32, bit for bit, on a seeded nano at 128 px."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule

    module = YoloxModule.from_config(
        YoloxConfig.get_named_config("yolox_nano"), rng_seed=3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (2, 128, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        dets_a, va = postprocess_device(module(x), 80, 1e-5, 0.65, False,
                                        256)
        raw, grid, stride = module.head.forward_raw(
            module.backbone(module._image_batch(x)))
        dets_b, vb = postprocess_fused(raw, grid, stride, 80, 1e-5, 0.65,
                                       False, 256)
    torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert va.sum() > 0
    torch.testing.assert_close(dets_a[va], dets_b[vb], rtol=0, atol=0)
    dets_c, vc = module.serve(x, conf_thre=1e-5, nms_thre=0.65,
                              max_det=256)
    torch.testing.assert_close(va, vc, rtol=0, atol=0)
    torch.testing.assert_close(dets_a[va], dets_c[vc], rtol=0, atol=0)


def test_postprocess_fused_matches_jax():
    """The same seeded raw outputs (B 2, 3 levels at 64 px, 6 classes)
    through both packages' `postprocess_fused`: the same valid mask, rows
    at `assert_dets_match`'s rtol 1e-6 (exp may differ by an ulp)."""
    rng = np.random.default_rng(11)
    grids, strides = [], []
    for s in (8, 16, 32):
        n = 64 // s
        yv, xv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        grids.append(np.stack([xv, yv], -1).reshape(-1, 2))
        strides.append(np.full((n * n, 1), s))
    grid = np.concatenate(grids).astype(np.float32)
    stride = np.concatenate(strides).astype(np.float32)
    a = len(grid)
    raw = np.concatenate([
        rng.normal(0, 1, (2, a, 4)),
        rng.uniform(0, 1, (2, a, 1)),
        rng.uniform(0, 1, (2, a, 6)),
    ], -1).astype(np.float32)
    for agnostic, conf in ((False, 0.3), (True, 0.1)):
        want_d, want_v = jnms.postprocess_fused(
            jnp.asarray(raw), jnp.asarray(grid), jnp.asarray(stride), 6,
            conf, 0.45, agnostic, 32)
        got_d, got_v = postprocess_fused(
            torch.from_numpy(raw), torch.from_numpy(grid),
            torch.from_numpy(stride), 6, conf, 0.45, agnostic, 32)
        assert np.asarray(want_v).sum() > 4
        assert_dets_match(got_d.numpy(), got_v.numpy(), np.asarray(want_d),
                          np.asarray(want_v), rtol=1e-6, atol=1e-5)


def test_port_ops_and_harnesses_import_no_jax():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'scripts')!r})\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import yolox_tpu_torch.ops as ops\n"
        "[getattr(ops, n) for n in ops.__all__]\n"
        "import torch_quant_accuracy, torch_eval_at_scale\n"
        "import torch_verify_pretrained\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'yolox_tpu.')) or m == 'yolox_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
