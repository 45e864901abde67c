"""YOLOX-Darknet53 (`yolov3`) in the harness, on the CPU at small sizes in
float32, both networks built through the architecture (`archs/yolov3.py`:
`reference`, `program`): the port's forward and its served detections
against the plain reference, the seeded-weight rules' keys, the FLOP and
parameter counts at 640 px, and the `non_gemm_ms_per_img` reader on a
trace built by hand. The cell's sound run, its broken runs (half a batch,
an altered box) and its float8 control are cases of the harness's
parametrized tests (`test_perfbench_faults.py`,
`test_perfbench_control.py`)."""

import json

import numpy as np
import pytest
import torch

from perfbench import cells, compare, flops, images, serving, weights
from perfbench.reference import postprocess
from perfbench.trace import WINDOW, TraceView
from perfbench_small import HERE, small_config

SIZE = 64
SEED = 2 ** 31 + 2207


def _config():
    return json.loads((HERE / "configs" / "yolov3.json").read_text())


@pytest.fixture(scope="module")
def small():
    cfg = small_config("yolov3", size=SIZE)
    arch = cells.arch(cfg)
    state = serving.make_state(cfg, SEED, "cpu")
    module, _ = arch.program(cfg, state, "cpu", torch.float32)
    ref = arch.reference(cfg)
    ref.load_state_dict(state)
    x = torch.from_numpy(np.stack(images.frames([(SIZE, SIZE)] * 3, 6,
                                                "cpu")))
    return module, ref, x


def test_forward_matches_port(small):
    """Both sides run float32 convs on the CPU, which may sum in another
    order (the tolerance of `test_perfbench_reference.py`: rtol 1e-4 over
    the 4608-term sums of the 3x3 convs at 512 channels, atol 1e-3 on
    decoded boxes of some hundred pixels)."""
    module, ref, x = small
    with torch.no_grad():
        got, want = module(x), ref.decoded(x)
    assert got.shape == want.shape == (3, 84, 85)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_serve_detections_match_reference_postprocess(small):
    module, ref, x = small
    dets, valid = module.serve(x, conf_thre=0.3, nms_thre=0.65, max_det=64)
    prog = serving.rows_from_serve(dets.numpy(), valid.numpy())
    with torch.no_grad():
        dec = ref.decoded(x)
    assert sum(len(p) for p in prog) > 0
    for p, d in zip(prog, dec):
        gap_sum, box_off = compare.pair_gaps(p, d)
        assert gap_sum <= 1e-4 * max(len(p), 1) and box_off == 0
        want = postprocess.detect(d[None], 0.3, 0.65, 64)[0]
        assert len(want) == len(p)
        np.testing.assert_allclose(p[:, :4], want[:, :4], rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(p[:, 5], want[:, 6])


def test_stem_and_residual_keys():
    """No key keeps a stem draw: the pixel conv's taps sum to zero like
    every other 3x3 conv's (`archs/yolov3.py::STEM`). RESIDUAL takes the
    second conv of each ResLayer: 1 in the stem, 2 / 8 / 8 / 4 in
    dark2-dark5."""
    cfg = small_config("yolov3", size=SIZE)
    arch = cells.arch(cfg)
    ref = arch.reference(cfg, device="meta")
    keys = list(ref.state_dict())
    assert not [k for k in keys if arch.STEM.search(k)]
    residual = [k for k in keys if arch.RESIDUAL.search(k)]
    assert len(residual) == 23
    assert all(".layer2.conv.weight" in k for k in residual)
    state = weights.seeded_state(weights.state_shapes(ref), cfg["init"],
                                 SEED, "cpu", torch.float32, arch)
    pixel = state["backbone.backbone.stem.0.conv.weight"]
    assert pixel.shape == (32, 3, 3, 3)
    torch.testing.assert_close(pixel.sum((2, 3)),
                               torch.zeros(32, 3), atol=1e-6, rtol=0)
    assert pixel.std().item() == pytest.approx(
        weights.CONV_GAIN / 27 ** 0.5, rel=0.2)


def test_flops_and_parameters_at_640():
    """184.68 GFLOP counted, 0.3% under the 185.3 published, and 63.72 M
    parameters (63.7 published)."""
    cfg = _config()
    assert flops.config_flops(cfg) == 184_679_014_400
    net = cells.arch(cfg).reference(cfg, device="meta")
    assert sum(p.numel() for p in net.parameters()) == 63_724_767


def _x(name, cat, start, end):
    return {"ph": "X", "cat": cat, "name": name, "ts": start,
            "dur": end - start, "pid": 1, "tid": 1}


# (name, category, start µs, end µs) in a 1000 µs window of 4 images
DEVICE = [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "kernel", 0, 300),
    ("void at::native::batch_norm_transform_input_kernel<c10::BFloat16>",
     "kernel", 300, 400),
    ("void at::native::vectorized_elementwise_kernel<4, where_kernel>",
     "kernel", 400, 460),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>",
     "kernel", 460, 480),
    ("void cudnn::cnn::implicit_convolve_sgemm<float>", "kernel", 480, 520),
    ("nms_keep_kernel", "kernel", 520, 530),
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 600, 700),
    ("Memset (Device)", "gpu_memset", 700, 705),
    # cut by the window's end: 10 µs of its 40 inside
    ("void at::native::elementwise_kernel<128, add>", "kernel", 990, 1030),
]


def _view(device=DEVICE, images=4):
    events = [_x(WINDOW, "user_annotation", 0, 1000)]
    events += [_x(*d) for d in device]
    return TraceView(events, {"images": images}, {"config": {}})


def test_non_gemm_reads_bn_and_elementwise_kernels():
    reader = cells.module("metrics", "non_gemm_ms_per_img")
    assert reader.UNIT == "ms/img"
    # BN 100, where 60, transpose 20, K2 10, add 10 µs; the GEMMs, the
    # copy and the memset left out
    assert reader.read(_view()) == pytest.approx(200e-3 / 4)
    assert reader.read(_view(images=0)) is None
    gemm_only = [d for d in DEVICE if "gemm" in d[0] or d[1] != "kernel"]
    assert reader.read(_view(gemm_only)) is None
