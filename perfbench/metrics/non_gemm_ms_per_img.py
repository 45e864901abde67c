"""non_gemm_ms_per_img: device time of the kernels that are neither a
convolution nor a GEMM, in milliseconds, over the images whose detections
reached the host in the traced window.

The `kernel` intervals of the window whose name GEMM does not match,
summed (not their union): eval BN, the activations, residual adds, the
layout transposes, pools, upsample, concat, the decode and K2. Copies and
memsets are left out (`h2d_ms_per_img` reads the copies). Work that a
later change moves into the conv kernels (a folded BN, a fused epilogue)
leaves this number and lowers it. None where no such kernel ran.

GEMM names the H100's convolution and matrix kernels as cuDNN, cuBLAS and
CUTLASS call them (`sm90_xmma_fprop_implicit_gemm_*`, `*_cudnn_*gemm*`,
`nvjet_*`, `cutlass_*`, `*winograd*`), and PyTorch's own convolution
kernels (`conv_depthwise2d_*`, `slow_conv*`). It leaves the transposes
(`nchwToNhwcKernel`, `nhwcToNchwKernel`) and the type conversions
(`convert*`) to the non-GEMM side."""

import re

UNIT = "ms/img"
GEMM = re.compile(r"(?i)gemm|xmma|cutlass|nvjet|winograd|conv(?!ert)")


def read(view):
    images = view.info.get("images")
    hits = [t - s for name, cat, s, t in view.device
            if cat == "kernel" and not GEMM.search(name)]
    if not hits or not images:
        return None
    return sum(hits) / 1e6 / images
