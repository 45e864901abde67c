"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`; each test skips when no CUDA device is present. Imports no
JAX, so on a machine without it run them past the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 float32 at 1e-4 + 1e-6 |ref| (108-term sums reassociated),
bf16 within one bf16 ulp; K2 bit-equal keep masks.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    anchor_scores,
    assert_detections_match,
    gap_threshold,
    nms_edge_cases,
    random_boxes,
    spread_scores,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
@pytest.mark.parametrize("c,h,w", [(32, 64, 96), (48, 34, 70), (8, 2, 2)])
@pytest.mark.parametrize("in_dtype", ["uint8", "float32", "bfloat16"])
def test_stem_kernel_matches_plain(cuda, in_dtype, c, h, w, act):
    from yolox_tpu_torch.ops.stem import (
        stem_conv_bn_act,
        stem_conv_bn_act_plain,
    )

    rng = np.random.default_rng(c + h)
    img = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    x = img.to(cuda, getattr(torch, in_dtype))
    wb = torch.from_numpy(rng.uniform(-0.1, 0.1, (c, 3, 6, 6)).astype(
        np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(cuda)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = stem_conv_bn_act.launches
        got = stem_conv_bn_act(x, wb, scale, bias, act, out_dtype)
        assert stem_conv_bn_act.launches == before + 1
        ref = stem_conv_bn_act_plain(x, wb, scale, bias, act, out_dtype)
        torch.cuda.synchronize()
        assert got.shape == (2, c, h // 2, w // 2) and got.dtype == out_dtype
        err = (got.float() - ref.float()).abs()
        if out_dtype == torch.float32:
            assert (err <= 1e-4 + 1e-6 * ref.abs()).all()
        else:
            assert (err <= 2.0 ** -7 * ref.float().abs() + 1e-6).all()


@pytest.mark.parametrize("k", [1, 37, 128, 1000, 1024])
def test_nms_kernel_matches_plain(cuda, k):
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(random_boxes(rng, 4, k)).to(cuda)
    scattered = torch.from_numpy(rng.random((4, k)) > 0.2).to(cuda)
    prefix = torch.arange(k, device=cuda)[None] < torch.tensor(
        [[0], [1], [k // 2], [k]], device=cuda)
    for valid in (scattered, prefix):
        for thr in (0.3, 0.65):
            got = nms_keep(boxes, valid, thr)
            assert torch.equal(got, nms_keep_plain(boxes, valid, thr))


def test_nms_kernel_edge_cases(cuda):
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    boxes, valid = (torch.from_numpy(a).to(cuda) for a in nms_edge_cases())
    for thr in (0.0, 0.5, 0.65, 1.0):
        assert torch.equal(nms_keep(boxes, valid, thr),
                           nms_keep_plain(boxes, valid, thr))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from yolox_tpu_torch.ops.nms_kernel import nms_keep
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    boxes = torch.zeros((1, 1025, 4), device=cuda)
    with pytest.raises(ValueError, match="K = 1025"):
        nms_keep(boxes, torch.ones((1, 1025), dtype=torch.bool,
                                   device=cuda), 0.5)
    with pytest.raises(ValueError, match="float32"):
        nms_keep(boxes[:, :8].double(), torch.ones((1, 8), dtype=torch.bool,
                                                   device=cuda), 0.5)
    x = torch.zeros((1, 64, 64, 3), dtype=torch.uint8, device=cuda)
    wb = torch.zeros((32, 3, 6, 6), device=cuda)
    sb = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="even"):
        stem_conv_bn_act(x[:, :63], wb, sb, sb)
    with pytest.raises(ValueError, match="float32"):
        stem_conv_bn_act(x, wb.double(), sb, sb)
    with pytest.raises(ValueError, match="contiguous"):
        stem_conv_bn_act(x.transpose(1, 2), wb, sb, sb)


def test_serve_on_cuda_matches_cpu(cuda):
    from yolox_tpu_torch import Yolox, YoloxConfig, YoloxModule, YoloxProcessor

    cfg = YoloxConfig.get_named_config("yolox_nano")
    cfg.test_size = (256, 256)
    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=3, device="cpu"),
        np.random.default_rng(4).integers(0, 256, (2, 256, 256, 3),
                                          dtype=np.uint8))
    gpu_mod = YoloxModule.from_config(cfg, rng_seed=3)
    gpu_mod.load_params(cpu_mod.state_dict())
    frames = [np.random.default_rng(5 + i).integers(
        0, 256, (256, 256, 3), dtype=np.uint8) for i in range(3)]
    thr, gap = gap_threshold(anchor_scores(cpu_mod, np.stack(frames)), 0.1,
                             0.3)
    assert gap > 1e-3
    got = Yolox(gpu_mod, YoloxProcessor(cfg))(frames, threshold=thr)
    want = Yolox(cpu_mod, YoloxProcessor(cfg))(frames, threshold=thr)
    assert sum(len(d["labels"]) for d in want) > 10
    assert_detections_match(got, want)
