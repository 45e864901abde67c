"""The serving kernels as registered PyTorch operators, so that a
`torch.export` program carries them.

The wrappers launch their kernels through `ctypes` on raw `data_ptr()`s
(`ops/_build.py`), which `torch.export` cannot trace. Each kernel of the
serving path is therefore also an operator in the `yolox_tpu_torch`
namespace, with a fake implementation that states its output's shape,
dtype and strides:

    yolox_tpu_torch::stem_conv_bn_act   K1 (`ops/stem.py`)
    yolox_tpu_torch::nms_keep           K2 (`ops/nms_kernel.py`)
    yolox_tpu_torch::int8_conv          Q1 (`ops/int8_conv.py`)
    yolox_tpu_torch::int8_dwconv        Q2 (`ops/int8_conv.py`)

Each wrapper is decorated with `exportable(name)`, the one place that
routes: an eager call runs the wrapper's own body (`wrapper.direct`),
since an operator call costs the host more than a Python call and b1
serving is host-bound; while `torch.compiler.is_exporting()` it calls
the operator, whose body is `wrapper.direct` again: on CUDA tensors the
kernel (its launch counter counts), on CPU tensors the plain PyTorch
version. Importing `yolox_tpu_torch` registers the operators, so a saved
program loads with `torch.export.load` after `import yolox_tpu_torch`.
The operators import their wrappers' modules when called: those modules
import this one for `exportable`.
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional

import torch

NAMESPACE = "yolox_tpu_torch"
OPS = ("stem_conv_bn_act", "nms_keep", "int8_conv", "int8_dwconv")


def exportable(op_name: str):
    """Decorator of a kernel's wrapper: the returned function is the
    wrapper when called eagerly, and calls the operator
    `yolox_tpu_torch::<op_name>` with the same arguments (defaults
    filled in) while `torch.export` traces it. The undecorated wrapper
    is its `.direct`, which the operator runs."""

    def wrap(direct):
        sig = inspect.signature(direct)

        @functools.wraps(direct)
        def call(*args, **kwargs):
            if torch.compiler.is_exporting():
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                return getattr(torch.ops.yolox_tpu_torch, op_name)(
                    *bound.args)
            return direct(*args, **kwargs)

        call.direct = direct
        return call

    return wrap


@torch.library.custom_op(f"{NAMESPACE}::stem_conv_bn_act", mutates_args=())
def stem_conv_bn_act(x: torch.Tensor, wb: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, act: str,
                     out_dtype: torch.dtype) -> torch.Tensor:
    from yolox_tpu_torch.ops import stem

    return stem.stem_conv_bn_act.direct(x, wb, scale, bias, act, out_dtype)


@stem_conv_bn_act.register_fake
def _(x, wb, scale, bias, act, out_dtype):
    """NCHW; the plain version's conv on the NHWC image leaves it stored
    channels_last on the CPU."""
    b, h, w, _ = x.shape
    out = x.new_empty((b, wb.shape[0], h // 2, w // 2), dtype=out_dtype)
    if x.device.type == "cpu":
        out = out.contiguous(memory_format=torch.channels_last)
    return out


@torch.library.custom_op(f"{NAMESPACE}::nms_keep", mutates_args=())
def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, thr: float,
             rows: Optional[int] = None,
             group: Optional[int] = None) -> torch.Tensor:
    from yolox_tpu_torch.ops import nms_kernel

    return nms_kernel.nms_keep.direct(boxes, valid, thr, rows, group)


@nms_keep.register_fake
def _(boxes, valid, thr, rows=None, group=None):
    return valid.new_empty(valid.shape, dtype=torch.bool)


def _int8_fake(x, w, scale, ksize, stride, out_dtype, out_scale):
    """Q1 / Q2's output: (B, Cout, Ho, Wo) stored channels_last, int8 codes
    with `out_scale`, else `out_dtype`."""
    from yolox_tpu_torch.ops.int8_conv import _out_hw

    b, _, h, wd = x.shape
    ho, wo = _out_hw(h, wd, ksize, stride)
    dtype = torch.int8 if out_scale is not None else out_dtype
    return x.new_empty((b, ho, wo, scale.shape[0]),
                       dtype=dtype).permute(0, 3, 1, 2)


@torch.library.custom_op(f"{NAMESPACE}::int8_conv", mutates_args=())
def int8_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, ksize: int, stride: int, act: str,
              out_dtype: torch.dtype,
              out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    from yolox_tpu_torch.ops import int8_conv as q

    return q.int8_conv.direct(x, w, scale, bias, ksize, stride, act,
                              out_dtype, out_scale)


@int8_conv.register_fake
def _(x, w, scale, bias, ksize, stride, act, out_dtype, out_scale):
    return _int8_fake(x, w, scale, ksize, stride, out_dtype, out_scale)


@torch.library.custom_op(f"{NAMESPACE}::int8_dwconv", mutates_args=())
def int8_dwconv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, ksize: int, stride: int, act: str,
                out_dtype: torch.dtype,
                out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    from yolox_tpu_torch.ops import int8_conv as q

    return q.int8_dwconv.direct(x, w, scale, bias, ksize, stride, act,
                                out_dtype, out_scale)


@int8_dwconv.register_fake
def _(x, w, scale, bias, ksize, stride, act, out_dtype, out_scale):
    return _int8_fake(x, w, scale, ksize, stride, out_dtype, out_scale)


def exported_ops(program) -> dict:
    """{operator name: nodes calling it} over every graph of an
    `ExportedProgram` (or a `GraphModule`), nested ones included."""
    gm = getattr(program, "graph_module", program)
    counts = {name: 0 for name in OPS}
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            if node.op != "call_function":
                continue
            packet = getattr(node.target, "_overloadpacket", None)
            ns, _, name = str(getattr(packet, "_qualified_op_name", "")
                              ).partition("::")
            if ns == NAMESPACE and name in counts:
                counts[name] += 1
    return counts
