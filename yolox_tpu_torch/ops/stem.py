"""K1: the Focus stem as one hand-written CUDA kernel (`csrc/stem.cu`).

Replaces the TPU kernel `yolox_tpu/ops/pallas_stem.py::_stem_kernel`,
which computes the same function as an im2col matmul on the TPU's matrix
unit over a space-to-depth copy of the image.

Bound on an H100: bytes. 2 * 108 operations per output value take 0.023
ms for 32 640 px images on the tensor cores, the NCHW store of the
output 0.125 ms (float32) at 3.35 TB/s. The kernel reads the letterboxed
NHWC batch itself and runs an implicit GEMM on the tensor cores (uint8 and
bf16 images): K = the 108 taps, padded to 112 with zeros, the float32
weights split into three bf16 terms (one when the weights are
bf16-exact), sums in float32, 128 channels a pass over the batch. Eval
BN and the activation run in float32 before one NCHW store of 16-byte
vectors, so neither a float copy of the image nor the pre-BN conv output
reaches device memory. A float32 image takes a CUDA-core loop in the same
source.

`stem_conv_bn_act` launches the kernel for CUDA tensors and runs the plain
PyTorch version, `stem_conv_bn_act_plain`, only for CPU tensors; under
`torch.export` it calls the registered operator (`ops/library.py`), which
runs the same body.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.library import exportable
from yolox_tpu_torch.utils.trace import span

_IN_CODES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_CODES = {torch.float32: 1, torch.bfloat16: 2}
_ACT_CODES = {"silu": 0, "relu": 1, "lrelu": 2}


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activations of the port's blocks as functions."""
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "lrelu":
        return torch.where(y >= 0, y, 0.1 * y)
    raise AttributeError(f"Unsupported act type: {act}")


def stem_conv_bn_act_plain(x, wb, scale, bias, act: str = "silu",
                           out_dtype=torch.float32):
    """Plain PyTorch version of K1: conv on the folded weight, eval BN, act,
    all in f32. x (B, H, W, 3) NHWC -> (B, C, H/2, W/2) NCHW `out_dtype`."""
    k = wb.shape[-1] // 2
    xf = x.permute(0, 3, 1, 2).float()
    y = F.conv2d(xf, wb.float(), stride=2, padding=k - 1)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return activate(y, act).to(out_dtype)


def _check(x, wb, scale, bias, act, out_dtype):
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"stem kernel: want (B, H, W, 3), got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"stem kernel: H and W must be even, got "
                         f"{x.shape[1]}x{x.shape[2]}")
    if x.dtype not in _IN_CODES:
        raise ValueError(f"stem kernel: input dtype {x.dtype} not supported")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"stem kernel: output dtype {out_dtype} not supported")
    if act not in _ACT_CODES:
        raise AttributeError(f"Unsupported act type: {act}")
    cout = wb.shape[0]
    if tuple(wb.shape) != (cout, 3, 6, 6):
        raise ValueError(f"stem kernel: want wb (C, 3, 6, 6), got "
                         f"{tuple(wb.shape)}")
    for name, t in (("wb", wb), ("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"stem kernel: {name} must be float32 on {x.device}")
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError("stem kernel: scale and bias must be (C,)")
    if not all(t.is_contiguous() for t in (x, wb, scale, bias)):
        raise ValueError("stem kernel: inputs must be contiguous")


@exportable("stem_conv_bn_act")
def stem_conv_bn_act(x, wb, scale, bias, act: str = "silu",
                     out_dtype=torch.float32):
    """Fused Focus stem. x (B, H, W, 3) NHWC uint8 / float32 / bfloat16,
    wb (C, 3, 6, 6) folded kernel, scale / bias (C,) float32 eval-BN fold.
    Returns (B, C, H/2, W/2) NCHW in `out_dtype` (float32 or bfloat16)."""
    with span("yolox.k1"):
        if x.device.type == "cpu":
            return stem_conv_bn_act_plain(x, wb, scale, bias, act, out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"stem kernel: unsupported device {x.device}")
        _check(x, wb, scale, bias, act, out_dtype)
        b, h, w, _ = x.shape
        cout = wb.shape[0]
        out = torch.empty((b, cout, h // 2, w // 2), dtype=out_dtype,
                          device=x.device)
        if out.numel() == 0:
            return out
        _build.launch(_build.load("stem").yolox_stem_conv_bn_act, x.device,
                      "stem kernel", x.data_ptr(), _IN_CODES[x.dtype],
                      wb.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                      out.data_ptr(), _OUT_CODES[out_dtype], b, h, w, cout,
                      _ACT_CODES[act])
        stem_conv_bn_act.launches += 1
        return out


stem_conv_bn_act.launches = 0
