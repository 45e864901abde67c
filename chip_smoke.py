#!/usr/bin/env python3
"""Run the PyTorch port (`yolox_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. start: the card's name and power limit, the torch and CUDA versions,
   and the build of every kernel under `yolox_tpu_torch/csrc/` (one nvcc
   per source, all started together);
2. K1, the stem kernel, against its plain PyTorch version at the yolox-s
   stem's shapes (B 1 and 8, 640 px, uint8 / float32 in, float32 / bf16
   out);
3. K2, the NMS kernel, against its plain version: bit-equal keep masks on
   random boxes (B 8, K 1024, with and without the class offset) and on
   edge cases (zero-area, identical, touching, negative-extent boxes, IoU
   exactly at the threshold, all-invalid rows, K 128);
4. the serving path of yolox-s at full width and 640 px: `Yolox.__call__`
   on 1, 3 and 8 uint8 frames and `Yolox.stream` over 10 frames, with the
   kernels' launch counters read around that run; the results against the
   same model on the CPU (plain versions); `YoloxModule.serve` and
   `YoloxModule.__call__` against the committed goldens
   `tests/golden/s_serve_seed4321.npz` and `s_seed4321.npz`;
5. times with CUDA events after warm-up at B 1 and 32: each kernel, its
   plain version, a one-call-chain PyTorch yardstick for K1, and serve
   latency (B 1) and throughput (B 32) in float32 and bfloat16.

Then one JSON line describing the kernels, the `nvidia-smi` name and power
limit, and as the last line `{"ok": true, "device": {...}}`.

TF32 is turned off here (cuDNN and matmul) before any comparison with
float32 references; the package itself never changes global flags.
The helpers above `main` import nothing at module level beyond numpy, so
the CPU tests use them too.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"

# NVIDIA H100 SXM data sheet, dense: float32 on CUDA cores, HBM3 bandwidth
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12
# float operations of one IoU and its test in `pairwise_iou_xyxy`
# (4 max/min, 2 compares, 4 subtracts, 3 multiplies, 2 adds, 1 divide, 1 compare)
IOU_FLOPS = 17

F32_ATOL, F32_RTOL = 1e-4, 1e-6
# the golden models score every anchor 1.0003e-4 +- 1e-8; the port's scores
# agree with JAX's to ~1e-7, so golden rows may swap within this band
GOLDEN_TIE = 1e-5
BF16_ULP = 2.0 ** -7


# ----------------------------------------------------------------- helpers

def random_boxes(rng, b, k, lo=50.0, hi=500.0):
    """(b, k, 4) float32 xyxy boxes with centres in [lo, hi), sides 20-120."""
    cx, cy = rng.uniform(lo, hi, (2, b, k))
    w, h = rng.uniform(20, 120, (2, b, k))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    -1).astype(np.float32)


def nms_edge_cases(k=128):
    """(boxes (6, k, 4) float32, valid (6, k) bool) of cases where IoU
    formulas part ways: identical boxes; zero-area boxes; boxes touching
    along an edge or at a corner; negative extents; pairs with IoU exactly
    0.5; an all-invalid row."""
    rng = np.random.default_rng(11)
    boxes = np.zeros((6, k, 4), np.float32)
    valid = np.ones((6, k), bool)
    boxes[0] = [10, 20, 60, 90]                                # identical
    pts = rng.integers(0, 40, (k, 2)).astype(np.float32)       # zero area
    ext = rng.integers(0, 3, (k, 2)).astype(np.float32) * 10
    ext[::2, 0] = 0
    ext[1::2, 1] = 0
    boxes[1] = np.concatenate([pts, pts + ext], 1)
    g = np.arange(k, dtype=np.float32)                          # touching
    boxes[2] = np.stack([g % 16 * 10, g // 16 * 10,
                         g % 16 * 10 + 10, g // 16 * 10 + 10], 1)
    neg = random_boxes(rng, 1, k, 0, 100)[0]                    # negative
    flip = rng.random(k) < 0.5
    neg[flip] = neg[flip][:, [2, 1, 0, 3]]
    flip = rng.random(k) < 0.5
    neg[flip] = neg[flip][:, [0, 3, 2, 1]]
    boxes[3] = neg
    half = np.zeros((k, 4), np.float32)                         # IoU 0.5
    base = (np.arange(k) // 2 * 4).astype(np.float32)
    half[:, 0], half[:, 1] = base, base
    half[:, 2] = base + np.where(np.arange(k) % 2 == 0, 2, 1)
    half[:, 3] = base + 1
    boxes[4] = half
    boxes[5] = random_boxes(rng, 1, k)[0]                       # all invalid
    valid[5] = False
    valid[1, ::7] = False
    return boxes, valid


def assert_dets_match(got, got_valid, want, want_valid, rtol=1e-4,
                      atol=1e-2, tie=None):
    """Fixed-shape detections (B, N, 7) against a reference: `valid`
    exactly, each valid row at (rtol, atol). A row may stand at another
    position only where the reference's scores (obj * cls_conf) at the two
    positions agree within relative `tie` (default `rtol`): scores tied
    that closely may order either way once the sums run in another
    order."""
    tie = rtol if tie is None else tie
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    got_valid, want_valid = np.asarray(got_valid), np.asarray(want_valid)
    np.testing.assert_array_equal(got_valid, want_valid)
    for b in range(want.shape[0]):
        g, w = got[b][got_valid[b]], want[b][want_valid[b]]
        score = w[:, 4] * w[:, 5]
        used = np.zeros(len(g), bool)
        for i in range(len(w)):
            group = np.nonzero(np.abs(score - score[i])
                               <= tie * np.abs(score[i]))[0]
            for j in group:
                if not used[j] and np.allclose(g[j], w[i], rtol=rtol,
                                               atol=atol):
                    used[j] = True
                    break
            else:
                raise AssertionError(
                    f"image {b}: reference row {i} {w[i].tolist()} has no "
                    f"match at positions {group.tolist()}")


def detections_as_rows(dets):
    """`Detections` dicts -> per image (n, 7) rows (box, score, 1, label),
    the layout `assert_dets_match` reads."""
    out = []
    for d in dets:
        rows = [list(box) + [s, 1.0, lab] for box, s, lab in
                zip(d["bboxes"], d["scores"], d["labels"])]
        out.append(np.asarray(rows, np.float64).reshape(-1, 7))
    return out


def assert_detections_match(got, want, rtol=1e-4, atol=1e-2):
    assert len(got) == len(want)
    for g, w in zip(detections_as_rows(got), detections_as_rows(want)):
        assert g.shape == w.shape, (g.shape, w.shape)
        n = len(w)
        assert_dets_match(g[None], np.ones((1, n), bool), w[None],
                          np.ones((1, n), bool), rtol, atol)


def spread_scores(module, x, std=1.0, bias=-2.0):
    """Give a seeded random model decisive scores. With random weights and
    identity BN the activations shrink about 3x per conv, so every anchor
    scores ~1e-4 and the scores differ only past the sixth digit. Here the
    obj and cls prediction convs of each level are rescaled so that their
    logits on `x` have standard deviation `std` around `bias`; scores then
    spread over (0, 0.6). The box regressors stay as they are, so boxes
    keep the anchors' geometry (IoUs of at most ~0.3)."""
    import torch

    head = module.head
    spreads, hooks = {}, []
    for conv in list(head.obj_preds) + list(head.cls_preds):
        hooks.append(conv.register_forward_hook(
            lambda m, _, out: spreads.__setitem__(
                m, (out - m.bias[None, :, None, None]).float().std().item())))
    try:
        module(x)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for conv, sd in spreads.items():
            if sd > 0:
                conv.weight.mul_(std / sd)
                conv.bias.fill_(bias)
    return module


def anchor_scores(module, x):
    """(B, A) obj * max cls_conf of the decoded model output."""
    out = module(x)
    return (out[..., 4] * out[..., 5:].amax(-1)).cpu().numpy()


def gap_threshold(scores, lo, hi):
    """A score threshold in the widest relative gap between the `scores`
    that lie in [lo, hi]: two runs whose scores differ in the last digits
    then keep the same candidates. Returns (threshold, relative gap)."""
    s = np.sort(scores[(scores >= lo) & (scores <= hi)].ravel())
    ratio = s[1:] / s[:-1]
    i = int(np.argmax(ratio))
    return float(np.sqrt(s[i] * s[i + 1])), float(ratio[i] - 1)


def stem_bound(b, h, w, c, in_bytes, out_bytes):
    """Least time of K1 on an H100 (ms) and what sets it: each input byte
    read once, each output byte written once; 2 * 108 float32 operations
    per output value on CUDA cores."""
    ho, wo = h // 2, w // 2
    nbytes = b * h * w * 3 * in_bytes + b * c * ho * wo * out_bytes \
        + c * (108 + 2) * 4
    flops = 2 * 108 * c * ho * wo * b
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def nms_bound(valid):
    """Least time of K2 on an H100 (ms) for these inputs: the IoU of every
    pair of valid boxes (i < j) in float32, and boxes, valid and keep each
    moved once."""
    valid = np.asarray(valid)
    b, k = valid.shape
    n = valid.sum(1).astype(np.float64)
    flops = IOU_FLOPS * float((n * (n - 1) / 2).sum())
    nbytes = b * k * (16 + 1 + 1)
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def cuda_ms(fn, iters, warmup=3):
    """Mean time of fn() on the card from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ phases

def phase_start():
    import torch

    from yolox_tpu_torch.ops import _build

    log("card:", nvidia_smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build (parallel nvcc): {time.perf_counter() - t0:.1f} s")


def phase_stem(rng, wb, scale, bias):
    """K1 against its plain version; returns the float32-output max error."""
    import torch

    from yolox_tpu_torch.ops.stem import (
        stem_conv_bn_act,
        stem_conv_bn_act_plain,
    )

    f32_err = 0.0
    for b in (1, 8):
        img = torch.from_numpy(
            rng.integers(0, 256, (b, 640, 640, 3), dtype=np.uint8)).cuda()
        for x in (img, img.float()):
            for out_dtype in (torch.float32, torch.bfloat16):
                got = stem_conv_bn_act(x, wb, scale, bias, "silu",
                                       out_dtype).float()
                ref = stem_conv_bn_act_plain(x, wb, scale, bias, "silu",
                                             out_dtype).float()
                err = (got - ref).abs()
                if out_dtype == torch.float32:
                    ok = bool((err <= F32_ATOL + F32_RTOL * ref.abs()).all())
                    f32_err = max(f32_err, err.max().item())
                else:
                    ok = bool((err <= BF16_ULP * ref.abs() + 1e-6).all())
                log(f"K1 b{b} {x.dtype} -> {out_dtype}: max |d| "
                    f"{err.max().item():.3g} (|ref| <= "
                    f"{ref.abs().max().item():.4g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K1 disagrees with its plain version")
    return f32_err


def phase_nms(rng):
    """K2 against its plain version: bit-equal keep masks."""
    import torch

    from yolox_tpu_torch.ops.nms import batched_nms_fixed
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    def check(name, boxes, valid, thr):
        got = nms_keep(boxes, valid, thr)
        ref = nms_keep_plain(boxes, valid, thr)
        ok = torch.equal(got, ref)
        log(f"K2 {name} thr {thr}: kept {int(got.sum())} of "
            f"{int(valid.sum())} valid, bit-equal {ok}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version: {name}")

    boxes = torch.from_numpy(random_boxes(rng, 8, 1024)).cuda()
    valid = torch.from_numpy(rng.random((8, 1024)) > 0.15).cuda()
    for thr in (0.3, 0.65):
        check("random b8 k1024", boxes, valid, thr)
    # the class-offset path of batched_nms_fixed, offset in f32 torch
    classes = torch.from_numpy(rng.integers(0, 80, (8, 1024))).cuda()
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    off = classes.float() * (masked.flatten(1).amax(1)[:, None] + 1)
    check("class-offset b8 k1024", (boxes + off[..., None]).contiguous(),
          valid, 0.65)
    scores = torch.ones(valid.shape, device=valid.device)
    want = nms_keep_plain((boxes + off[..., None]).contiguous(), valid, 0.65)
    if not torch.equal(batched_nms_fixed(boxes, scores, classes, 0.65, valid),
                       want):
        raise AssertionError("batched_nms_fixed disagrees with the plain path")
    eb, ev = nms_edge_cases()
    for thr in (0.5, 0.65):
        check("edge cases k128", torch.from_numpy(eb).cuda(),
              torch.from_numpy(ev).cuda(), thr)


def _frames(rng, n):
    return [rng.integers(0, 256, (640, 640, 3), dtype=np.uint8)
            for _ in range(n)]


def phase_serve(cfg, rng):
    """The main path: Yolox.__call__ and Yolox.stream on the card, counters
    read around that run, results against the CPU; then the goldens.
    Returns the launch counts, the card's model and a score threshold."""
    import torch

    from yolox_tpu_torch import Yolox, YoloxModule, YoloxProcessor
    from yolox_tpu_torch.ops.nms import postprocess_device
    from yolox_tpu_torch.ops.nms_kernel import nms_keep
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=4321, device="cpu"),
        np.random.default_rng(7).integers(0, 256, (2, 640, 640, 3),
                                          dtype=np.uint8))
    gpu_mod = YoloxModule.from_config(cfg, rng_seed=4321)
    gpu_mod.load_params(cpu_mod.state_dict())
    gpu, cpu = (Yolox(m, YoloxProcessor(cfg)) for m in (gpu_mod, cpu_mod))

    # 640 x 640 frames letterbox to themselves; each request's threshold
    # sits in a gap of the CPU's scores, so both devices keep the same
    # candidates (scores agree to ~1e-5 relative)
    requests = [_frames(rng, n) for n in (1, 3, 8)]
    stream_in = _frames(rng, 10)
    cuts = [gap_threshold(anchor_scores(cpu_mod, np.stack(f)), 0.25, 0.45)
            for f in requests + [stream_in]]
    log("score thresholds (relative gap): "
        + ", ".join(f"{t:.5f} ({g:.2g})" for t, g in cuts))
    if min(g for _, g in cuts) < 1e-3:
        raise AssertionError("no score gap wide enough to compare devices")
    thr = [t for t, _ in cuts]

    torch.cuda.synchronize()
    stem_conv_bn_act.launches = nms_keep.launches = 0
    got = [gpu(frames, threshold=t) for frames, t in zip(requests, thr)]
    got_stream = list(gpu.stream(stream_in, threshold=thr[-1], batch_size=4))
    torch.cuda.synchronize()
    launches = {"stem": stem_conv_bn_act.launches, "nms": nms_keep.launches}
    batches = len(requests) + 3
    log(f"main path: {batches} serve batches, launches {launches}")
    if launches != {"stem": batches, "nms": batches}:
        raise AssertionError("the main path did not run through K1 and K2 "
                             "once per batch")

    n_dets = 0
    for frames, t, dets in zip(requests, thr, got):
        assert_detections_match(dets, cpu(frames, threshold=t))
        n_dets += sum(len(d["labels"]) for d in dets)
    assert_detections_match(got_stream, cpu(stream_in, threshold=thr[-1]))
    assert_detections_match(got_stream[:8],
                            gpu(stream_in[:8], threshold=thr[-1]))
    log(f"Yolox.__call__ (1, 3, 8 frames) and stream (10 frames, batch 4) "
        f"match the CPU: {n_dets} detections on the calls")

    golden_mod = YoloxModule.from_config(cfg, rng_seed=4321)
    x = np.random.default_rng(98).uniform(0, 255, (2, 640, 640, 3)).astype(
        np.float32)
    dets, valid = golden_mod.serve(x, conf_thre=1e-5, max_det=64)
    want = np.load(GOLDEN / "s_serve_seed4321.npz")
    for tag in ("s2d_on", "s2d_off"):
        assert_dets_match(dets.cpu().numpy(), valid.cpu().numpy(),
                          want[f"dets_{tag}"], want[f"valid_{tag}"],
                          tie=GOLDEN_TIE)
    out = golden_mod(x)
    want = np.load(GOLDEN / "s_seed4321.npz")
    np.testing.assert_allclose(out.cpu().numpy()[:, ::997, :],
                               want["head_slice"], rtol=1e-4, atol=1e-3)
    dets, valid = postprocess_device(out, 80, 1e-5, 0.65, False, 64)
    assert_dets_match(dets.cpu().numpy(), valid.cpu().numpy(), want["dets"],
                      want["valid"], tie=GOLDEN_TIE)
    log("YoloxModule.serve / __call__ match the committed yolox-s goldens")
    return launches, gpu_mod, thr[2]


def phase_times(rng, gpu_mod, wb, scale, bias, threshold):
    import torch
    import torch.nn.functional as F

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from yolox_tpu_torch.ops.stem import (
        stem_conv_bn_act,
        stem_conv_bn_act_plain,
    )

    # F.batch_norm with mean 0, var 1 - eps applies the same scale / bias
    c = wb.shape[0]
    zeros = torch.zeros(c, device=wb.device)
    var = torch.full((c,), 1.0 - 1e-3, device=wb.device)
    times = {"stem": {}, "nms": {}, "serve": {}}
    for b in (1, 32):
        img = torch.from_numpy(
            rng.integers(0, 256, (b, 640, 640, 3), dtype=np.uint8)).cuda()
        iters = 50 if b == 1 else 10

        def library():
            x = img.permute(0, 3, 1, 2).float()
            y = F.conv2d(x, wb, stride=2, padding=2)
            y = F.batch_norm(y, zeros, var, scale, bias, False, 0.0, 1e-3)
            return F.silu(y)

        t = {
            "ms": cuda_ms(lambda: stem_conv_bn_act(img, wb, scale, bias),
                          iters),
            "plain_ms": cuda_ms(
                lambda: stem_conv_bn_act_plain(img, wb, scale, bias), iters),
            "library_ms": cuda_ms(library, iters),
        }
        t["bound_ms"], t["bound_by"] = stem_bound(b, 640, 640, wb.shape[0],
                                                  1, 4)
        times["stem"][b] = t
        log(f"K1 b{b} uint8 -> f32: {t}")

        # K2 at the serve shape, on the candidates this batch produces
        boxes, valid = serve_candidates(gpu_mod, img, threshold)
        t = {"ms": cuda_ms(lambda: nms_keep(boxes, valid, 0.65), iters),
             "plain_ms": cuda_ms(lambda: nms_keep_plain(boxes, valid, 0.65),
                                 max(2, iters // 5), warmup=1),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = nms_bound(valid.cpu().numpy())
        times["nms"][b] = t
        log(f"K2 b{b} K {boxes.shape[1]} ({int(valid.sum())} valid): {t}")

    for dtype in (torch.float32, torch.bfloat16):
        mod = gpu_mod if dtype == torch.float32 else \
            YoloxModule.from_config(gpu_mod.config, rng_seed=4321,
                                    dtype=dtype)
        if dtype != torch.float32:
            mod.load_params(gpu_mod.state_dict())
        for b, reps in ((1, 30), (32, 6)):
            x = rng.integers(0, 256, (b, 640, 640, 3), dtype=np.uint8)
            samples = []
            for i in range(reps + 3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets, valid = mod.serve(x, conf_thre=threshold,
                                        max_det=1024)
                dets.cpu(), valid.cpu()
                if i >= 3:
                    samples.append(time.perf_counter() - t0)
            med = float(np.median(samples))
            key = f"{str(dtype).split('.')[-1]}_b{b}"
            times["serve"][key] = {"median_ms": 1e3 * med,
                                   "img_per_s": b / med}
            try:
                dev_ms, top = device_breakdown(mod, x, threshold)
            except Exception as e:  # the profiler may not reach the card
                log(f"serve {key} device breakdown: not measured ({e})")
            else:
                if top:
                    times["serve"][key]["device_ms"] = dev_ms
                    times["serve"][key]["device_busy"] = dev_ms / (1e3 * med)
                log(f"serve {key} device kernels (ms per call): "
                    + json.dumps([(k[:60], round(v, 4)) for k, v in top[:8]]))
            log(f"serve {key} (host uint8 batch in, detections on the "
                f"host): {times['serve'][key]}")
    return times


def device_breakdown(module, x, threshold, reps=5):
    """Device time of one serve call by kernel, from torch.profiler (CUPTI):
    (device ms per call, [(kernel, ms per call), ...] largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    module.serve(x, conf_thre=threshold, max_det=1024)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dets, valid = module.serve(x, conf_thre=threshold, max_det=1024)
            dets.cpu(), valid.cpu()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        # device-side events only: an aten op repeats its kernels' time
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.self_device_time_total
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t / 1e3 / reps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return sum(per_kernel.values()), top


def serve_candidates(module, img, threshold):
    """The class-offset candidate boxes and valid mask that serve hands K2
    for this batch (max_det 1024)."""
    import torch

    from yolox_tpu_torch.ops import nms as nms_ops

    captured = {}
    real = nms_ops.nms_keep

    def spy(boxes, valid, thr):
        captured["args"] = (boxes.clone(), valid.clone())
        return real(boxes, valid, thr)

    nms_ops.nms_keep = spy
    try:
        module.serve(img, conf_thre=threshold, max_det=1024)
    finally:
        nms_ops.nms_keep = real
    torch.cuda.synchronize()
    return captured["args"]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        from yolox_tpu_torch import YoloxConfig, YoloxModule
        from yolox_tpu_torch.ops.nms_kernel import nms_keep
        from yolox_tpu_torch.ops.stem import stem_conv_bn_act
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2024)

    phase_start()
    cfg = YoloxConfig.get_named_config("yolox_s")
    stem_mod = YoloxModule.from_config(cfg, rng_seed=4321)
    focus = stem_mod.backbone.backbone.stem
    from yolox_tpu_torch.models.blocks import fold_focus_weight

    wb = fold_focus_weight(focus.conv.conv.weight).contiguous()
    c = wb.shape[0]
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).cuda()
    stem_err = phase_stem(rng, wb, scale, bias)
    phase_nms(rng)

    launches, gpu_mod, threshold = phase_serve(cfg, rng)
    times = phase_times(rng, gpu_mod, wb, scale, bias, threshold)

    kernels = []
    for name, source, replaces, n, err, t in (
            ("stem_conv_bn_act", "yolox_tpu_torch/csrc/stem.cu",
             "yolox_tpu/ops/pallas_stem.py:89", launches["stem"], stem_err,
             times["stem"]),
            ("nms_keep", "yolox_tpu_torch/csrc/nms.cu",
             "yolox_tpu/ops/pallas_nms.py:31", launches["nms"], 0.0,
             times["nms"])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"],
            "bound_ms": t[1]["bound_ms"], "bound_by": t[1]["bound_by"],
            "library_ms": t[1]["library_ms"],
            "b32": {k: t[32][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")},
        })
    log(json.dumps({"serve": times["serve"]}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
