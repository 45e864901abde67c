#!/usr/bin/env python
"""Analytic traffic model of the port's serving forward (no device
needed): the counterpart of `scripts/serve_traffic_model.py`.

Takes a census of every convolution of `yolox_tpu_torch`'s serving
forward (backbone + `head.forward_raw_levels`) on `meta` tensors, so no
arithmetic runs and any batch costs nothing. Each conv is charged one read
of its input and one write of its output in the compute dtype (its
logical bytes) and 2 * output size * kh * kw * Cin / groups FLOPs. Rows
are keyed as the JAX census keys them: (Cin, Cout, input height,
depthwise). The Focus stem counts as the folded 6x6 stride-2 conv on the
3-channel image, row (3, C, H, False), whichever route runs it (K1 on a
card, its plain version elsewhere): it has the FLOPs and bytes of the
12 -> C 3x3 conv on the space-to-depth tensor. Weights and elementwise
ops are not counted (small next to the activations).

The JAX model's `padded` column (TPU 128-lane tiles) is dropped: the
H100's HBM has no such tiles. `--lane-fold` is dropped too: the port has
no lane folding (`ops/lane_fold.py` is a TPU layout, not ported).

Prints the per-shape table, the totals and the bound img/s at the H100's
HBM rate and its tensor-core (bf16) or CUDA-core (float32) peak, then the
same as one JSON line. `scripts/torch_profile_serve.py` takes its FLOPs
from this census.

    python scripts/torch_serve_traffic_model.py [--model nano]
        [--batch 256] [--dtype {bfloat16,float32}]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from contextlib import contextmanager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, float32 on
# the CUDA cores (TF32 off), HBM3 bandwidth
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

# the JAX tools' per-model serve batches (`bench.py:SERVE_BATCH`)
SERVE_BATCH = {"nano": 256, "tiny": 256, "s": 256, "m": 128, "l": 96,
               "x": 32, "yolov3": 64}

DTYPES = ("bfloat16", "float32")


def peak_flops(dtype) -> float:
    """The H100's peak for convs in `dtype` (a torch dtype or its name)."""
    return H100_F32_FLOPS if str(dtype).endswith("float32") else \
        H100_BF16_FLOPS


def named_config(model: str):
    from yolox_tpu_torch import YoloxConfig

    name = model if model == "yolov3" else f"yolox_{model}"
    cfg = YoloxConfig.get_named_config(name)
    if cfg is None:
        raise SystemExit(f"unknown model {model!r}")
    return cfg


class ConvCensus:
    """Conv rows {(Cin, Cout, H, depthwise): [n, logical bytes, FLOPs]}
    of what runs under `count(part)`, with totals per part. Built on a
    `TorchDispatchMode` (every `aten.convolution`, however a module calls
    it) and forward hooks on the Focus stems (which K1 runs outside aten
    on a card)."""

    def __init__(self, itemsize: int):
        self.itemsize = itemsize
        self.rows = defaultdict(lambda: [0, 0, 0])
        self.parts = defaultdict(lambda: [0, 0])  # part -> [bytes, FLOPs]
        self.part = None
        self.in_stem = False

    def add(self, cin, cout, h, depthwise, in_numel, out_numel, taps):
        """One conv: `taps` = kh * kw * Cin / groups."""
        logical = (in_numel + out_numel) * self.itemsize
        flops = 2 * out_numel * taps
        row = self.rows[(int(cin), int(cout), int(h), bool(depthwise))]
        row[0] += 1
        row[1] += logical
        row[2] += flops
        part = self.parts[self.part]
        part[0] += logical
        part[1] += flops

    @contextmanager
    def count(self, module, part):
        """Record the convs run inside the block under `part`."""
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        from yolox_tpu_torch.models.blocks import Focus

        census = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if (func is torch.ops.aten.convolution.default
                        and not census.in_stem):
                    x, w, groups = args[0], args[1], args[8]
                    census.add(x.shape[1], out.shape[1], x.shape[2],
                               groups > 1, x.numel(), out.numel(),
                               w.shape[1] * w.shape[2] * w.shape[3])
                return out

        def stem_in(mod, args):
            census.in_stem = True

        def stem_out(mod, args, out):
            # the folded 2k x 2k stride-2 conv on the NHWC image
            census.in_stem = False
            x = args[0]
            k = 2 * mod.conv.conv.kernel_size[0]
            census.add(x.shape[3], out.shape[1], x.shape[1], False,
                       x.numel(), out.numel(), k * k * x.shape[3])

        hooks = []
        for m in module.modules():
            if isinstance(m, Focus):
                hooks += [m.register_forward_pre_hook(stem_in),
                          m.register_forward_hook(stem_out)]
        self.part = part
        try:
            with Mode():
                yield self
        finally:
            for h in hooks:
                h.remove()
            self.part, self.in_stem = None, False


@contextmanager
def _plain_kernels():
    """The Focus stems run K1's plain version and the BaseConvs the eval
    epilogue's, which take meta tensors (the census counts the convs by
    their hooks, whatever runs inside)."""
    from yolox_tpu_torch.models import blocks
    from yolox_tpu_torch.ops.bn_act import bn_act_plain
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act_plain

    kernels = blocks.stem_conv_bn_act, blocks.bn_act
    blocks.stem_conv_bn_act, blocks.bn_act = stem_conv_bn_act_plain, \
        bn_act_plain
    try:
        yield
    finally:
        blocks.stem_conv_bn_act, blocks.bn_act = kernels


def conv_census(model: str, batch: int, dtype: str = "bfloat16",
                size: int = None) -> dict:
    """The census of `model`'s serving forward at `batch` x `size` px
    (default the model's test size) in `dtype`: {"rows": {key: [n,
    logical bytes, FLOPs]}, "parts": {"backbone" | "head": [bytes,
    FLOPs]}, "logical", "flops", "size"}."""
    import torch

    from yolox_tpu_torch import YoloxModule

    cfg = named_config(model)
    size = size or cfg.test_size[0]
    tdtype = getattr(torch, dtype)
    module = YoloxModule.from_config(cfg, dtype=tdtype, device="cpu")
    module = module.to("meta")
    x = torch.empty((batch, size, size, 3), dtype=tdtype, device="meta")
    census = ConvCensus(tdtype.itemsize)
    with torch.no_grad(), _plain_kernels():
        with census.count(module, "backbone"):
            fpn = module.backbone(x)
        with census.count(module, "head"):
            module.head.forward_raw_levels(fpn)
    rows = {k: list(v) for k, v in census.rows.items()}
    return {"rows": rows,
            "parts": {k: list(v) for k, v in census.parts.items()},
            "logical": sum(r[1] for r in rows.values()),
            "flops": sum(r[2] for r in rows.values()), "size": size}


def bounds(batch: int, logical: float, flops: float, dtype: str) -> dict:
    """Bound img/s at the H100's HBM rate and conv peak."""
    return {"hbm_img_per_s": batch / (logical / H100_HBM_BYTES),
            "flop_img_per_s": batch / (flops / peak_flops(dtype))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="nano")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    args = ap.parse_args(argv)

    batch = args.batch or SERVE_BATCH[args.model]
    census = conv_census(args.model, batch, args.dtype)
    rows, logical, flops = census["rows"], census["logical"], census["flops"]
    bound = bounds(batch, logical, flops, args.dtype)

    print(f"# yolox-{args.model} serving forward, {census['size']}px "
          f"batch {batch}, {args.dtype}")
    print(f"{'Cin->Cout':>12} {'spat':>5} {'dw':>3} {'n':>3} "
          f"{'logical GB':>11} {'GFLOP':>9}")
    for (cin, cout, sp, dw), (n, lg, fl) in sorted(
            rows.items(), key=lambda kv: -kv[1][1]):
        print(f"{cin:>6}->{cout:<5} {sp:>5} {'dw' if dw else '':>3} {n:>3} "
              f"{lg / 1e9:>11.5f} {fl / 1e9:>9.4f}")
    n_convs = sum(r[0] for r in rows.values())
    print(f"\ntotals: {len(rows)} shapes, {n_convs} convs, logical "
          f"{logical / 1e9:.5f} GB, {flops / 1e9:.7f} GFLOP")
    print(f"HBM bound ({H100_HBM_BYTES / 1e12:.2f} TB/s): "
          f"{bound['hbm_img_per_s']:.0f} img/s")
    print(f"FLOP bound ({peak_flops(args.dtype) / 1e12:.0f} TFLOP/s "
          f"{args.dtype}): {bound['flop_img_per_s']:.0f} img/s")
    result = {
        "model": args.model, "batch": batch, "size": census["size"],
        "dtype": args.dtype, "shapes": len(rows), "convs": n_convs,
        "logical_bytes": logical, "flops": flops,
        "parts": census["parts"], **bound,
        "rows": [[*k, *v] for k, v in sorted(
            rows.items(), key=lambda kv: -kv[1][1])],
        "peaks": {"hbm_bytes_per_s": H100_HBM_BYTES,
                  "flops_per_s": peak_flops(args.dtype)}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
