"""Precisions of the reference and of its control.

The reference computes in float32 with TF32 off (`strict_float32`). The
control is the same reference one step below the configuration's stated
precision (bfloat16): every convolution's input and weight rounded to
float8 e4m3 with one scale per tensor (`fp8`), the products still summed
in float32. It rounds values only: under autograd the cast would hand
each gradient back in float8 with no scale, which no float8 training
does, so `fp8` refuses a tensor that needs a gradient.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def strict_float32():
    """float32 matmuls and convolutions without TF32, within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 at a per-tensor scale (amax -> 448), back
    in its own dtype."""
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError("fp8 rounds values, not gradients: run the control "
                         "under torch.no_grad()")
    amax = t.abs().amax().float().clamp_min(1e-12)
    scale = E4M3_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)
