#!/usr/bin/env python
"""Train-step breakdown of the port on the card: where do the ms go?
The counterpart of `scripts/profile_train.py`.

Five successive slices of the training step on JAX's inputs (float32
0-255 pixels from `np.random.default_rng(0)`, two labels an image, lr
0.01), the module's weights float32 and the compute in bfloat16:

  fwd eval-mode (bf16)             a bfloat16 copy of the module in eval
                                   mode, decoded head (K1 runs the stem);
  fwd train-mode (BN batch stats)  `forward_train`;
  fwd + SimOTA loss                + `compute_losses`;
  fwd + loss + grad (bwd)          + the backward;
  full train step                  `make_train_step(compute_dtype=bf16)`.

`--fused-bwd` runs every BaseConv through the fused-backward Function
(`ops/conv_bwd.py`), whose 1x1 SiLU convs take K3 and K4 in the backward:
the port's main training path. Without it the backward is autograd's
(JAX's script leaves `fused_bwd` at its default, off). Train-mode stages
move the BN running statistics and the full step the weights, as JAX's
donated state does; nothing is compared across stages.

Each stage computes the JAX tool's checksum and gets the two times of
`scripts/torch_profile_serve.py` (events ms, best of 3 runs of `iters`
calls; device ms, each call queued behind a spin kernel) and their busy
share, the kernels' own time from torch.profiler, and the device's peak
memory over the stage. A step launches more than CUDA's launch queue
holds (~1 000), so where the host is the slower side its gaps still show
in the device ms; the kernels ms and the trace (`--trace DIR`:
`DIR/train_trace.json`, 3 full steps after an unprofiled one;
`scripts/torch_trace_report.py DIR --iters 3`) count kernel time alone.
The default B 64, 640 px fits an 80 GB card: the unfused bfloat16 step,
which keeps the most activations for the backward, peaked at 21.8 GB on
an H100 80GB HBM3 (10.3 GB with `--fused-bwd`); the peak is printed per
stage.

Runs on the CUDA card unless given `--device cpu`, and exits non-zero
when asked for a card that is not there.

    python scripts/torch_profile_train.py [--model s] [--batch 64]
        [--iters 8] [--fused-bwd] [--trace DIR] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_serve import (  # noqa: E402
    card,
    checked_call,
    fmt,
    nvidia_smi,
    times,
    write_trace,
)
from torch_serve_traffic_model import named_config  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, float32 on
# the CUDA cores (TF32 off), HBM3 bandwidth
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12


def train_inputs(batch, size):
    """JAX's inputs: (pixels (B, S, S, 3) float32, labels (B, 10, 5))."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    labels = np.zeros((batch, 10, 5), np.float32)
    labels[:, 0] = [1, size / 2, size / 2, size / 3, size / 3]
    labels[:, 1] = [5, size / 4, size / 4, size / 4, size / 5]
    return x, labels


def train_stages(module, x, labels, num_classes, fused_bwd=False,
                 compute_dtype=None, lr=0.01):
    """[(stage name, fn)]: each fn runs the stage once and returns JAX's
    checksum as a 0-d float32 device tensor. `module` is float32 and
    trains in place; x, labels are device tensors."""
    import torch

    from yolox_tpu_torch.core import init_train_state, make_train_step
    from yolox_tpu_torch.models.assign import compute_losses

    dtype = compute_dtype or torch.bfloat16
    xc = x.to(dtype)
    eval_module = copy.deepcopy(module).to(dtype).eval()

    def csum(out):
        return out[:, 0, :4].float().sum()

    def fwd_eval():
        with torch.inference_mode():
            return csum(eval_module.head(eval_module.backbone(xc)))

    def fwd_train():
        module.train()
        with torch.no_grad():
            return csum(module.forward_train(xc, fused_bwd)["outputs"])

    def loss():
        module.train()
        out = module.forward_train(xc, fused_bwd)
        return compute_losses(out, labels, num_classes)["total_loss"]

    def fwd_loss():
        with torch.no_grad():
            return loss()

    def fwd_loss_grad():
        module.zero_grad(set_to_none=True)
        total = loss()
        total.backward()
        # fold every gradient into the checksum, as JAX's does
        return total.detach() + 1e-20 * sum(
            p.grad.float().mean() for p in module.parameters()
            if p.grad is not None)

    state = init_train_state(module)
    step = make_train_step(module, num_classes, compute_dtype=dtype,
                           fused_bwd=fused_bwd)

    def full_step():
        _, losses = step(state, x, labels, lr)
        return losses["total_loss"]

    return [("fwd eval-mode (bf16)", fwd_eval),
            ("fwd train-mode (BN batch stats)", fwd_train),
            ("fwd + SimOTA loss", fwd_loss),
            ("fwd + loss + grad (bwd)", fwd_loss_grad),
            ("full train step", full_step)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="s")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--fused-bwd", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from yolox_tpu_torch import YoloxModule

    dev = card(args.device)
    on_card = dev.type == "cuda"
    cfg = named_config(args.model)
    size = cfg.input_size[0]
    b, iters = args.batch, args.iters
    module = YoloxModule.from_config(cfg, dtype=torch.float32, device=dev)
    x, labels = (torch.from_numpy(a).to(dev) for a in train_inputs(b, size))

    result = {"model": args.model, "batch": b, "size": size,
              "fused_bwd": args.fused_bwd, "iters": iters,
              "device": str(dev), "card": nvidia_smi() if on_card else None,
              "stages": []}
    if on_card:
        print("card:", result["card"])
    stages = train_stages(module, x, labels, cfg.num_classes, args.fused_bwd)
    for tag, fn in stages:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        checksum, launches = checked_call(fn)
        row = {"stage": tag, "checksum": checksum, "launches": launches,
               **times(fn, iters, on_card)}
        ev, devt = row["events_ms"], row["device_ms"]
        row.update({"img_per_s": b / ev * 1e3 if ev else None,
                    "busy": devt / ev if ev else None,
                    "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                if on_card else None)})
        result["stages"].append(row)
        print(f"{tag:36s} events {fmt(ev, '9.2f', ' ms')}"
              f"  device {fmt(devt, '9.2f', ' ms')}"
              f"  kernels {fmt(row['kernel_ms'], '9.2f', ' ms')}"
              f"  {fmt(row['img_per_s'], '9.1f', ' img/s')}"
              f"  busy {fmt(row['busy'], '.3f')}"
              f"  peak {fmt(row['peak_gb'], '.2f', ' GB')}", flush=True)
    if args.trace:
        result["trace"] = write_trace(
            stages[-1][1], 3, os.path.join(args.trace, "train_trace.json"),
            on_card)
        print(f"trace written to {result['trace']}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
