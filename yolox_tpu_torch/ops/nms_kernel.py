"""K2: greedy NMS suppression as a hand-written CUDA kernel (`csrc/nms.cu`).

Replaces the TPU kernel `yolox_tpu/ops/pallas_nms.py::_nms_kernel` and
computes the keep mask of the JAX package's default suppression,
`yolox_tpu/ops/nms.py::_greedy_suppress`:
keep[j] = valid[j] and no kept i < j has iou(i, j) > thr, for K up to
~448k (`launch_plan` refuses more: the mask alone would be 25 GB an
image).

Bound on an H100: an image needs at most K(K-1)/2 IoUs and moves 18 bytes
a box, far below what the card does in a microsecond at serving sizes; the
greedy walk over the valid boxes, one dependent step a box, and the fixed
cost of a launch bound it. One launch a call (`launch_plan` holds its
arithmetic): blocks of 256 threads fill a (B, K, W2) uint64 suppression
mask in global memory across the SMs, G row tiles of 64 boxes against
four column tiles a block (G = 1 below 8 images, 4 from 8), only on or
right of the diagonal; the last block of each image to finish (an
arrival counter, as K3 does) walks it, the mask rows staged into a
three-slot shared-memory ring while one warp decides the rows in score
order (design note in `csrc/nms.cu`).

`nms_keep` launches the kernel for CUDA tensors and runs the plain
PyTorch version, `nms_keep_plain`, only for CPU tensors.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.boxes import pairwise_iou_xyxy
from yolox_tpu_torch.ops.library import exportable
from yolox_tpu_torch.utils.trace import span

TILE = 64               # boxes a tile side, bits a mask word
QUAD = 4                # column tiles a block (256 threads)
MAX_SMEM = 232448       # 227 KB, the most an H100 block may take
MAX_DYN = MAX_SMEM - 8192   # dynamic bytes beside the kernel's static 4.2 KB
SOFT_DYN = 57344        # keep 4 blocks an SM for the IoU tiles when R allows
SLOTS = 3               # the walk's ring: chunks c + 1 and c + 2 in flight
_HEADER = 48            # the walk's bytes between `removed` and the ring
_RINGS = (64, 32, 16, 8, 4, 2, 1)   # R: divides a 64-row group
# G, row tiles a block: below GROUP_B images the IoU work needs the
# spread (one row tile a block); from it the blocks' count costs more,
# each block's arrival costing ~1 us even when none of its rows is valid
# (serving at B 32: 0.0124 ms with G 1, 0.0092 with G 4; PERF.md §6)
GROUP_B = 8
GROUP_SMALL_B = 1
GROUP_LARGE_B = 4
# The launcher's packed arguments (`LaunchArgs` in csrc/nms.cu): six
# pointers, B, K, W2, R, G, tiles, smem, thr
_ARGS = struct.Struct("<13qd")


class LaunchPlan(NamedTuple):
    """The launch arithmetic of K2 for one (B, K)."""
    words: int          # W = ceil(K / 64) mask words a row
    row_words: int      # W2: W rounded up to even (rows 16-byte aligned)
    group: int          # G: row tiles a block (1, 2 or 4)
    tiles: int          # blocks an image: 2 (Q - 1) Q / G + ceil(W / G),
    #                     Q = ceil(W / 4) column quads; block t is (row
    #                     group t - 2q (q + 1) / G, quad q = floor((sqrt(2Gt
    #                     + 1) - 1) / 2)), quad q holding the groups whose
    #                     first row tile is at most 4q + 3
    grid: tuple         # (tiles, min(B, 65535)), 256 threads a block
    chunk_rows: int     # R: mask rows a ring slot (64 .. 1)
    smem_bytes: int     # dynamic shared memory: `removed` (8 W2), a
    #                     48-byte header, 3 ring slots of R W2 words
    scratch_bytes: int  # the valid words (B W2) and the mask (B K W2),
    #                     uint64; the B arrival counters are apart


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, k: int, rows: Optional[int] = None,
                group: Optional[int] = None) -> LaunchPlan:
    """`rows` forces R and `group` forces G (tests take the smaller rings
    and each G at sizes the plain version can check). By default R is the
    largest that keeps the dynamic shared memory within `SOFT_DYN`, else
    within `MAX_DYN`; G is `GROUP_SMALL_B` below `GROUP_B` images, else
    `GROUP_LARGE_B`. Raises ValueError where R rows do not fit `MAX_DYN`
    (by default: K past ~448k, whose mask alone is 25 GB an image)."""
    words = -(-k // TILE)
    row_words = words + (words & 1)
    quads = -(-words // QUAD)
    g = group or (GROUP_SMALL_B if b < GROUP_B else GROUP_LARGE_B)
    tiles = 2 * (quads - 1) * quads // g + -(-words // g)
    dyn = lambda r: 8 * row_words + _HEADER + SLOTS * r * row_words * 8  # noqa
    if rows is not None and rows not in _RINGS:
        raise ValueError(f"nms kernel: R = {rows} rows a chunk, want one of "
                         f"{_RINGS}")
    chunk = rows or next(
        (r for r in _RINGS if dyn(r) <= SOFT_DYN),
        next((r for r in _RINGS if dyn(r) <= MAX_DYN), 1))
    if dyn(chunk) > MAX_DYN:
        raise ValueError(
            f"nms kernel: K = {k} needs {dyn(chunk)} bytes of shared memory "
            f"for {chunk} mask row(s) a ring slot, past {MAX_DYN}; its mask "
            f"alone would be {8 * k * row_words} bytes an image")
    return LaunchPlan(words, row_words, g, tiles, (tiles, min(b, 65535)),
                      chunk, dyn(chunk), 8 * b * row_words * (k + 1))


# Per (device, stream), grown as needed: the arrival counters (int32,
# zeros, and the kernel leaves them 0) and the scratch of
# `LaunchPlan.scratch_bytes`. Launches on one stream run in order, so they
# share both. The counters are a tensor of their own: grown scratch that
# held an earlier call's words must never become counters. `_prepared`
# holds each (device, stream, B, K, R, G)'s launch arguments but the
# tensors', and is cleared when a buffer grows.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_prepared: Dict[tuple, tuple] = {}


def _buffers_for(device, stream, b, nbytes):
    """(counters, scratch) addresses for B images on `device`'s
    `stream`."""
    key = (device.index, stream)
    cnt, buf = _counters.get(key), _scratch.get(key)
    if cnt is None or cnt.numel() < b:
        cnt = torch.zeros(b, dtype=torch.int32, device=device)
        _counters[key] = cnt
        _prepared.clear()
    if buf is None or buf.numel() * 8 < nbytes:
        buf = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=device)
        _scratch[key] = buf
        _prepared.clear()
    return cnt.data_ptr(), buf.data_ptr()


def _launch_args(device, stream, b, k, rows, group):
    """The launcher's arguments after boxes, valid and keep: (mask,
    vwords, counters, B, K, W2, R, G, tiles, smem)."""
    key = (device.index, stream, b, k, rows, group)
    args = _prepared.get(key)
    if args is None:
        p = launch_plan(b, k, rows, group)
        counters, vwords = _buffers_for(device, stream, b, p.scratch_bytes)
        args = (vwords + 8 * b * p.row_words, vwords, counters, b, k,
                p.row_words, p.chunk_rows, p.group, p.tiles, p.smem_bytes)
        _prepared[key] = args
    return args


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
            # a new tensor, never `valid` itself: the operator's output
            # may not alias its input
            return new_keep
        keep = new_keep


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   thr: float) -> torch.Tensor:
    """Plain PyTorch version of K2: boxes (B, K, 4) xyxy, valid (B, K) bool
    -> keep (B, K) bool."""
    return greedy_suppress(pairwise_iou_xyxy(boxes, boxes), valid, thr)


@exportable("nms_keep")
def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, thr: float,
             rows: Optional[int] = None,
             group: Optional[int] = None) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted, already class-offset boxes.
    boxes (B, K, 4) float32 xyxy, valid (B, K) bool. Returns keep (B, K)
    bool. `rows` and `group` force R and G (`launch_plan`)."""
    with span("yolox.k2"):
        dev = boxes.device
        if dev.type == "cpu":
            return nms_keep_plain(boxes, valid, thr)
        if dev.type != "cuda":
            raise ValueError(f"nms kernel: unsupported device {dev}")
        shape = boxes.shape
        if len(shape) != 3 or shape[2] != 4:
            raise ValueError(f"nms kernel: want boxes (B, K, 4), got "
                             f"{tuple(shape)}")
        if boxes.dtype != torch.float32:
            raise ValueError(f"nms kernel: boxes must be float32, got "
                             f"{boxes.dtype}")
        if valid.dtype != torch.bool or valid.shape != shape[:2] \
                or valid.device != dev:
            raise ValueError("nms kernel: valid must be (B, K) bool on the "
                             "boxes' device")
        if not (boxes.is_contiguous() and valid.is_contiguous()):
            raise ValueError("nms kernel: inputs must be contiguous")
        b, k = shape[0], shape[1]
        keep = torch.empty((b, k), dtype=torch.bool, device=dev)
        if b == 0 or k == 0:
            return keep
        stream = _build.stream(dev)
        args = _launch_args(dev, stream, b, k, rows, group)
        try:
            _build.launch(_build.load("nms").yolox_nms_keep, dev, "nms kernel",
                          _ARGS.pack(boxes.data_ptr(), valid.data_ptr(),
                                     keep.data_ptr(), *args, thr))
        except RuntimeError:
            _counters.pop((dev.index, stream), None)  # state unknown
            _prepared.clear()
            raise
        nms_keep.launches += 1
        return keep


nms_keep.launches = 0
