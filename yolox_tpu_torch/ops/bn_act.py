"""The eval epilogue of a BaseConv as one hand-written CUDA kernel
(`csrc/bn_act.cu`): y = act(z * scale + bias) per channel, in float32
(BN's output rounded to z's dtype in between, in registers), stored once
in the conv output's dtype and memory format.

Replaces no TPU kernel: XLA fuses eval BN and the activation into the conv
on the TPU. Under PyTorch's cuDNN route they were library kernels of their
own after the conv (eval BN one pass over the map, SiLU one, LReLU three),
each reading and writing the whole map; this is the one pass left. A
weight fold alone would not remove it: cuDNN adds a conv's bias in a pass
of its own too, and the activation's passes would stay.

Bound on an H100: bytes, 4 an element in bf16 (read once, written once).

`bn_act` launches the kernel for CUDA tensors and runs the plain PyTorch
version, `bn_act_plain`, only for CPU tensors; under `torch.export` it
calls the registered operator (`ops/library.py`), which runs the same
body. While autograd records, the kernel's output takes the plain
version's gradients (`plain_grads`), both eagerly and through the
operator, so an eval module stays differentiable on the card.
"""

from __future__ import annotations

import torch

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.library import exportable
from yolox_tpu_torch.ops.stem import _ACT_CODES, activate

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}


def bn_act_plain(z, scale, bias, act: str = "silu"):
    """Plain PyTorch version: float32 z * scale + bias (a multiply, then an
    add) rounded to z's dtype, as eval BN stored it and as the JAX
    package's `batch_norm` returns it; the activation in float32, then the
    cast back to z's dtype; z's memory format. z (B, C, H, W), scale and
    bias (C,)."""
    y = z.float() * scale.float()[:, None, None] + bias.float()[:, None, None]
    return activate(y.to(z.dtype).float(), act).to(z.dtype)


def _layout(z) -> int:
    """0 for an NCHW-contiguous z, 1 for a channels_last one; raises on any
    other layout."""
    if z.is_contiguous():
        return 0
    if z.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError("bn_act kernel: z must be NCHW-contiguous or "
                     f"channels_last, got strides {z.stride()}")


def _check(z, scale, bias, act):
    if z.dim() != 4:
        raise ValueError(f"bn_act kernel: want z (B, C, H, W), got "
                         f"{tuple(z.shape)}")
    if z.dtype not in _DTYPE_CODES:
        raise ValueError(f"bn_act kernel: dtype {z.dtype} not supported")
    if act not in _ACT_CODES:
        raise AttributeError(f"Unsupported act type: {act}")
    c = z.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != z.device or t.dtype != torch.float32:
            raise ValueError(f"bn_act kernel: {name} must be float32 on "
                             f"{z.device}")
        if tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"bn_act kernel: {name} must be a contiguous "
                             f"({c},)")
    if c * z.shape[2] * z.shape[3] >= 2 ** 31:
        raise ValueError("bn_act kernel: an image of 2^31 elements or more")


def plain_grads(z, scale, bias, act, grad, needs):
    """The gradients of `bn_act_plain` at (z, scale, bias) for the output
    gradient `grad`, None where `needs` (one flag an input) is false: the
    backward of the kernel and of the operator."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n)
               for t, n in zip((z, scale, bias), needs)]
        y = bn_act_plain(*ins, act)
        got = iter(torch.autograd.grad(
            y, [t for t in ins if t.requires_grad], grad))
    return tuple(next(got) if n else None for n in needs)


class _Recorded(torch.autograd.Function):
    """The kernel forward, `plain_grads` backward."""

    @staticmethod
    def forward(ctx, z, scale, bias, act):
        ctx.save_for_backward(z, scale, bias)
        ctx.act = act
        return _launch(z, scale, bias, act)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_grads(*ctx.saved_tensors, ctx.act, grad,
                             ctx.needs_input_grad[:3]), None)


@exportable("bn_act")
def bn_act(z, scale, bias, act: str = "silu"):
    """Eval BN and the activation of a conv's output. z (B, C, H, W)
    float32 or bfloat16, NCHW-contiguous or channels_last; scale and bias
    (C,) float32 (`BaseConv.bn_fold`). Returns act(z * scale + bias) in
    z's dtype and memory format."""
    if z.device.type == "cpu":
        return bn_act_plain(z, scale, bias, act)
    if z.device.type != "cuda":
        raise ValueError(f"bn_act kernel: unsupported device {z.device}")
    if torch.is_grad_enabled() and (z.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _Recorded.apply(z, scale, bias, act)
    return _launch(z, scale, bias, act)


def _launch(z, scale, bias, act):
    """The kernel's output, after the checks."""
    _check(z, scale, bias, act)
    layout = _layout(z)
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    b, c, h, w = z.shape
    _build.launch(_build.load("bn_act").yolox_bn_act, z.device,
                  "bn_act kernel", z.data_ptr(), out.data_ptr(),
                  scale.data_ptr(), bias.data_ptr(), _DTYPE_CODES[z.dtype],
                  layout, b, c, h * w, _ACT_CODES[act])
    bn_act.launches += 1
    return out


bn_act.launches = 0
