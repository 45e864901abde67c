"""K2: greedy NMS suppression as one hand-written CUDA kernel (`csrc/nms.cu`).

Replaces the TPU kernel `yolox_tpu/ops/pallas_nms.py::_nms_kernel` and
computes the keep mask of the JAX package's default suppression,
`yolox_tpu/ops/nms.py::_greedy_suppress`:
keep[j] = valid[j] and no kept i < j has iou(i, j) > thr.

Bound on an H100: at K = 1024 an image needs at most K(K-1)/2 = 0.5 M IoUs
(a few microseconds of CUDA-core work) and moves ~20 KB, so neither the
operations nor the bytes bound it: the serial greedy walk over K boxes
does, and at small batch one image occupies one SM. The design keeps
everything in shared memory: all threads of the block fill the K x K
suppression bitmask at once, and one warp then walks it with one OR per
kept box (torchvision's scheme). B images run as B blocks of one launch.

`nms_keep` launches the kernel for CUDA tensors and runs the plain
PyTorch version, `nms_keep_plain`, only for CPU tensors.
"""

from __future__ import annotations

import torch

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.boxes import pairwise_iou_xyxy

MAX_K = 1024


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                    thr: float) -> torch.Tensor:
    """Greedy NMS over score-sorted candidates from their (..., K, K) IoU
    matrix, as the fixpoint keep[j] = valid[j] & !any(i < j: keep[i] &
    iou[i, j] > thr) (unique by induction over score order); one
    matrix-vector product per round until nothing changes."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    # sup[..., j, i] = candidate i is higher-scored than j and overlaps it
    sup = ((iou > thr) & (idx[None, :] < idx[:, None])).float()
    keep = valid
    while True:
        suppressed = (sup @ keep.float()[..., None])[..., 0] > 0.5
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   thr: float) -> torch.Tensor:
    """Plain PyTorch version of K2: boxes (B, K, 4) xyxy, valid (B, K) bool
    -> keep (B, K) bool."""
    return greedy_suppress(pairwise_iou_xyxy(boxes, boxes), valid, thr)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             thr: float) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted, already class-offset boxes.
    boxes (B, K, 4) float32 xyxy, valid (B, K) bool, K <= 1024 on CUDA.
    Returns keep (B, K) bool."""
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, thr)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms kernel: unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"nms kernel: want boxes (B, K, 4), got "
                         f"{tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if boxes.dtype != torch.float32:
        raise ValueError(f"nms kernel: boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) \
            or valid.device != boxes.device:
        raise ValueError("nms kernel: valid must be (B, K) bool on the "
                         "boxes' device")
    if k > MAX_K:
        raise ValueError(f"nms kernel: K = {k} > {MAX_K}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms kernel: inputs must be contiguous")
    keep = torch.empty((b, k), dtype=torch.uint8, device=boxes.device)
    if keep.numel() == 0:
        return keep.view(torch.bool)
    _build.launch(_build.load("nms").yolox_nms_keep, boxes.device,
                  "nms kernel", boxes.data_ptr(), valid.data_ptr(),
                  keep.data_ptr(), b, k, float(thr))
    nms_keep.launches += 1
    return keep.view(torch.bool)


nms_keep.launches = 0
