#!/usr/bin/env python3
"""Run the PyTorch port (`yolox_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. start: the card's name and power limit, the torch and CUDA versions,
   and the build of every kernel under `yolox_tpu_torch/csrc/` (one nvcc
   per source, all started together);
2. K1, the stem kernel, against its plain PyTorch version at the stem's
   shapes (B 1 and 8, 640 px, C 32 (yolox-s) and 80 (yolox-x), uint8 /
   float32 / bf16 in, float32 / bf16 out, float32 weights and
   bf16-exact ones) at `stem_limit`;
3. K2, the NMS kernel (one launch a call), against its plain version:
   bit-equal keep masks on random boxes (B 8, K 1024, with and without
   the class offset) and on edge cases (zero-area, identical, touching,
   negative-extent boxes, IoU exactly at the threshold, all-invalid rows,
   K 128);
4. the serving path of yolox-s at full width and 640 px: `Yolox.__call__`
   on 1, 3 and 8 uint8 640 x 640 frames and on a 1280 x 720 and a 500 x
   375 frame (letterbox ratios 0.5 and 1.28: their resize runs
   `data/cv2_compat.py`, whose route is printed), and `Yolox.stream` over
   10 frames, with the kernels' launch counters read around that run; the results against the
   same model on the CPU (plain versions); `YoloxModule.serve` and
   `YoloxModule.__call__` against the committed goldens
   `tests/golden/s_serve_seed4321.npz` and `s_seed4321.npz`;
5. times after warm-up: K1 at B 1 and 32 (uint8 in, float32 and bf16
   out) and K2 at `NMS_CASES` (serving's candidates at B 1 and 32,
   evaluation's at K 1024 (B 1 and 32), 2048, 4096 and 8400) by CUDA
   events and by device time alone (`queued_ms`), their plain versions,
   K1's cuDNN yardstick in the output's dtype, the bounds (`stem_bound`,
   `nms_bound`), and on K2's log lines its walk floor (`walk_floor_ms`)
   and device ms a walked box, and serve latency
   (B 1) and throughput (B 32) in float32 and bfloat16;
6. K3 and K4, the fused Conv-BN-SiLU backward kernels, against their plain
   versions at all 43 1x1 SiLU conv shapes of yolox-s (B 16, 640 px) and
   at the distinct shapes of every other size phase 10's multiscale can
   draw (480-800 px in steps of 32; HW such as 225, 625, 900 take no
   16-byte loads), float32 and bf16, on random x and
   g_y with the BN statistics of the conv's own forward (tolerances:
   `K3_TOL`, `K4_*_TOL`), K3's coefficient table against the torch
   expressions on its sums;
7. the training slice of yolox-s at full width and depth, 640 px, B 16,
   synthetic labels (1-30 boxes an image in 120 padded rows), through
   `make_train_step(fused_bwd=True)`: 3 steps in float32 and 3 in bf16
   with finite losses and the launch counters read around each step (K3
   and K4 43 times a step, K1, K2 and K5 never); with one SimOTA assignment
   held fixed, the fused step's gradients against the autograd step's
   (`fused_bwd=False`) on the card, and one B 2 step on the card against
   the same step on the CPU (plain versions); then step times for both
   `fused_bwd` settings in both dtypes, the device's busy share, and K3 /
   K4 times per launch and per step (CUDA events, and the kernels' own
   device time from torch.profiler) beside their plain versions, bounds
   and library yardsticks;
8. the augmentation slice: K5, the fused shear kernel (`shear_xy`: the
   warp's passes 2 and 3 and the transpose between them), bit-equal to
   its plain version with one launch a call at the 640 px warp's shape
   (B 16, float32 and bf16) on affine, unbounded random and edge shifts,
   and at a ragged size with px 1 and 3; the single-pass kernel
   (`shear_x`) bit-equal at the warp's two pass shapes and on random and
   edge shifts; `augment_with_draws` on the card against the CPU on one
   set of draws (B 2, 640 px: images before HSV within `AUG_IMG_TOL`, HSV
   within `AUG_HSV_TOL`, labels within `AUG_LABEL_TOL`, rows exact); the
   augmented main path, `make_augmented_train_step(fused_bwd=True)` on
   yolox-s at full width and depth, 640 px, B 16, 3 steps in float32 and
   3 in bf16 from a CUDA generator, with the launch counters read around
   each step (`shear_xy` once, `shear_x` never, K3 and K4 43 times, K1
   and K2 never); then the augmentation's time per batch, the augmented
   step against the plain step on an augmented batch, busy share and peak
   memory, and the fused K5's times beside its plain version,
   `shear_xy_bound`, the `F.grid_sample` yardstick and the two-launch
   path it replaced (both passes and the transpose, each timed).

9. (run after phase 5) evaluation: K2 bit-equal to its plain version at K
   1024, 1025, 2048, 4096 and 8400 (`phase_nms_any_k`); the oracle
   (`phase_oracle`: the ground truth at 0.99 under 1000 jittered
   duplicates of each box, through `CocoEvaluator` at max_det 1024 and
   2048 on the card and on the CPU: AP50 > 0.99, equal statistics and
   detections, only the ground truth kept); yolox-s at full width and
   depth through `get_evaluator` / `eval` on 64 in-memory images whose
   longer side is 640 (`phase_eval_model`: float32 against the CPU at
   `assert_dets_match` and `EVAL_F32_STAT_TOL`, bf16 at `EVAL_BF16_*`,
   the launch counters read around each card run, the COCO matching
   path printed); evaluation images/s over the set repeated 5 times (320
   images) and device ms a batch at B 32 in float32 and bf16 with a
   breakdown by stage (`eval_times`).

10. (run last) the trainer: `YoloxConfig.get_trainer(args).train()` on
   yolox-s at full width and depth, 640 px, B 16, bf16 (`fp16`),
   `fused_conv_bwd`, 96 in-memory images of mixed shapes (1-10 boxes
   each), 32 evaluation images, `max_epoch` 2, `no_aug_epochs` 0 (the
   mosaic closes at epoch index max_epoch - no_aug_epochs - 1, so epoch 1
   runs Mosaic/MixUp and epoch 2 letterboxes with L1), warm-up 1 epoch,
   evaluation every epoch, multiscale range 5, `min(8, cpu_count)` loader
   workers (`run_trainer`): (a) the host Mosaic/MixUp path from seeded
   starting weights, then the same run resumed from the checkpoint of its
   first epoch; (b) `device_augment` (tiles in, K5 on the card), then the
   no-aug epoch. Checked: finite losses, the LR of every iteration on
   `LRScheduler.update_lr`, the launch counters read around every
   iteration (K3 and K4 43 times, K5 once in a device-augmented epoch,
   else never) and evaluation (K1 and K2 once a batch), the checkpoint
   files (latest, last_mosaic_epoch, best), the resume's start epoch and
   EMA count and its epoch against (a)'s second (LR, mosaic closed, L1
   on), `best_ckpt.pth` loaded strict on the card and the CPU with equal
   float32 detections, `data/cv2_compat.py`'s numpy versions against
   this host's cv2 (`cv2_compat_vs_host`); timed: images/s by epoch,
   median iteration and loader-wait ms, the busy share of 3 profiled
   iterations, peak memory, the Mosaic loader alone on each route.

11. (run after phase 9) yolov3 and int8 serving (`run_int8`): Q1 and Q2,
   the int8 conv kernels, against their plain versions at every distinct
   conv shape of yolox-s (B 8, 640 px, the ladder's folded 6x6 stem
   included), yolov3 (B 2, 640 px) and nano (B 8, 416 px; Q2 at its
   depthwise shapes) and at edge cases (Cin 3 and 16, odd sizes, stride 2
   at the border, codes not 16-byte aligned): float32, bf16 and
   requantized outputs at the `Q_*` tolerances, the int32 sums exactly
   (relu, unit scale), repeat launches bit-equal; yolov3 at full width
   and depth: `YoloxModule.__call__` against
   `tests/golden/yolov3_seed777.npz`, `Yolox.__call__` on 1 and 3 frames
   against the CPU (K2 once a call, K1 and Q1 never); int8 yolox-s at 640
   px, both modes, float32 and bf16 modules, B 1 and 8, with a table
   calibrated on the CPU (and the card's own calibration against it):
   raw head outputs against the CPU (`INT8_*_TOL`), `Yolox.__call__`
   detections against the CPU's with the launch counters read around it
   (Q1 once per dense BaseConv, the ladder's stem included; K1 0 or 1 by
   mode; K2 once; Q2 never); nano int8 HBM at 416 px (Q2 once per
   depthwise conv); then serve latency (B 1) and throughput (B 32) of
   yolov3 (float32, bf16) and int8 yolox-s (both modes, bf16 module), Q1
   over one B 32 ladder call and Q2 over one nano call (device time,
   plain version, `int8_conv_bound`, cuDNN's bf16 conv and, at the
   largest and most frequent shape, `torch._int_mm` on an im2col).

12. (run last) the `yolox-tpu-torch` commands (`run_cli`), yolox-s at
   full width and depth, 640 px, seeded weights (`rng_seed` 4321, scores
   spread) saved to a `.pth`, on a COCO set of 16 images written with cv2
   whose boxes are the model's own detections: `eval` in float32 (AP50:95
   / AP50 equal to `config.eval` on the same module and set), bf16 and
   int8 HBM, then the three timed at B 32 on the set 10 times over (160
   images; images/s of the evaluation call and its parts, the command's
   start-up apart, the loader alone with its batches in shared memory and
   pickled (each over the same 4 batches, start-up excluded);
   `config.eval` before and after as the reference); `demo image` on a folder with a 1280 x 720 frame and `demo
   video` on an MJPG clip (every image and frame equal to
   `Yolox.__call__`, every frame written); `export` plain, with
   `--include-postprocess` (B 1 and 32) and `--int8`, each program
   reloaded with `torch.export.load` and run on the card, bit-equal to
   the eager forward / serve / int8 forward (else within phase 4's
   tolerances; which one held is printed), its operator nodes listed, the
   exported against eager serve times and the operators' host cost a
   call (`operator_cost`); `train` with `fused_conv_bwd` and
   `device_augment` (2 epochs of 2 iterations, B 8, bf16), then `eval` of
   its checkpoint; `visualize-assign` on the card and the CPU (equal
   PNGs). Every command's launch counters are read around it (K3 / K4 43
   times and K5 once a device-augmented step; K1 and K2 once a batch or
   call; Q1 73 times an HBM batch and 74 an exported int8 call).

13. (run last) data parallelism (`run_parallel`), yolox-s at full width
   and depth, 640 px: `remat` against the plain float32 B 16 fused step
   on one held SimOTA assignment (updates, momentum and BN statistics at
   `TRAIN_TOL`, every `num_batches_tracked` 1; then ms and peak memory of
   both); the same step through an NCCL process group of world size 1,
   bit-equal to the step with no group (deterministic cuDNN); then
   `PAR_WORLD` gloo ranks spawned on the one card
   (`torch.multiprocessing`, `parallel_rank`), each on its own half of a
   B 16 batch: the data-parallel step (float32 and bf16, `fused_bwd`,
   each half's assignment held) against the mean of two one-process steps
   in this process (`PAR_TOL`), the ranks' bytes equal after it, each
   rank's step ms and the gradient all-reduce's ms; 3 augmented steps
   (bf16, K5) per rank, each rank's batch remade from its seed bit-equal
   and the ranks equal after each step; the two-rank evaluation of the
   160-image CLI set at B 32 (16 a rank), its 12 statistics equal to one
   process's at B 16 (the same batches), timed beside one process at B
   32; `Trainer` on the CLI set (B 8, bf16, `fused_conv_bwd`,
   `device_augment`, 2 epochs with evaluations: checkpoints by rank 0
   only), then a run that rank 1 sends SIGTERM to itself after its first
   iteration: both ranks leave at that iteration and rank 0 writes the one
   resume checkpoint. A rank that fails fails the phase. Launch counters
   are read around every main-path run of both ranks; the phase's wall
   time is printed.

14. (run last) the serving meshes (`run_mesh`): `MESH_WORLD` gloo ranks
   spawned on the one card (`mesh_rank`), each case served through
   `make_serving_fn(mesh=...)` with the launch counters read around one
   call on every rank: yolox-s at full width and depth, 640 px, seeded
   weights (`rng_seed` 4321, scores spread), over (1, 2) at b1 and (2, 1)
   at b2 in float32 (TF32 off) and bf16, over (2, 2) at b2 in bf16; int8
   HBM and the ladder (bf16 module, one table calibrated here and handed
   to the ranks) over (1, 2) at b1; yolov3 over (1, 2) at b1 in float32;
   nano int8 HBM at 416 px over (1, 2) (uneven slabs, Q2); nano at 96 px
   over (1, 4) (3 slabs and an empty rank). Each case's threshold keeps
   at least `INT8_MIN_DETS` detections an image. Every rank's `(dets,
   valid)` must equal, bit for bit, this process's `serve` of the same
   module on the card at the rank's own batch (its `data` share, so the
   same shapes reach cuDNN apart from the slab's height): a halo placed
   wrongly or a kernel fault at a slab's shape shows there. Data-split
   cases are also held to one `serve` of the whole batch (`mesh_check`:
   float32 at `assert_dets_match`'s tolerances, bf16 row by row at the
   bf16 ones, since cuDNN may take another algorithm for another batch);
   launches as one process's on a rank with rows and K2's alone on an
   empty one; the
   (1, 1) mesh through an NCCL group of world size 1 bit-equal to
   `serve` (`mesh_nccl`); then per rank the meshed b1 call's median ms
   beside one process's, the exchanges a call, their bytes and host ms
   (what a rank pays on a shared card: no scaling figure).

15. (run last) the harnesses of `scripts/` (`run_harnesses`): (a)
   `torch_quant_accuracy` (nano overfit on noise images of 128 px,
   float32; 300 steps, as JAX's test, on the script's 4 images) and its
   table of the four int8 variants against float32 on those images, held
   to JAX's floor (>= 2 float detections; ladder and HBM at abs-max:
   agreement >= 0.8, score MAD <= 0.08); the same table over those images
   and 8 rolled copies of them (36 frames), reported; the launch
   counters read around
   the training and both tables (K1 8, K2 10, Q1 8 x its dense convs -
   4, Q2 8 x its depthwise convs); on the
   trained weights float `serve` card against CPU, and each variant
   through `int8_card_vs_cpu` at phase 11's tolerances (in the HBM mode
   the CPU's stem is held to K1's output at K1's tolerance and then runs
   on it, since one stem output near a code boundary flips a code that
   the trained layers carry on); (b)
   `torch_eval_at_scale` at 500 images, yolox-s, B 32, bf16: rc 0,
   detections on every image, K1 and K2 once a batch; (c)
   `torch_verify_pretrained` leg 1 on the card (the amplified nano
   `.pth`, three PNG files, expectations from the CPU): exit 0 (K1 and
   K2 once), 1 on moved boxes, 2 without weights (downloads refused);
   the phase's wall time.

16. (run last) the profiling tools of `scripts/` (`run_profilers`), each
   through its `main()` on yolox-s at full width and depth:
   `torch_serve_traffic_model` (B 32), `torch_profile_serve` at B 32 in
   bf16 with a trace and in float32 (TF32 off), `torch_trace_report` on
   that trace, `torch_profile_train` at B 16 with `--fused-bwd` and 1
   iteration, `torch_profile_augment` at B 16 with 1 iteration, then
   `torch_eval_memory_ab` (its two child processes) at 256 000
   detections on 250 images. Checked: every flop-bound and byte-bound
   share at most `PROFILE_ROOF_LIMIT` (above it a count is wrong); the
   serve stages' device ms rising within `PROFILE_RISE_TOL`; the trace
   report's device time an iteration within `PROFILE_TRACE_TOL` of the
   full-serve stage's device ms, with K1's and K2's kernels among its
   rows; each stage's launches (K1 once a serve stage and in the
   eval-mode forward, K2 once in the full serve, K3 and K4 once a 1x1
   SiLU conv in the backward and the full step, K5 once a batch); K5's
   kernel attributed to a frame of the package; both A/B modes' AP
   equal; every one of K1-K5 launched in the phase; the phase's wall
   time.

17. (run last) the host-against-device augmentation A/Bs
   (`run_augment_abs`): (a) the distribution check of
   `tests/test_torch_augment_equivalence.py` on the card: 384 samples of
   the device engine at 128 px from a seeded generator on the card (bf16
   products, K5 once a batch of 64) against 384 of the host pipeline
   (MosaicDetection + TrainTransform), held to JAX's bounds (|z| <
   `AUGEQ_Z` on box count, width, height, area, pad fraction and pixel
   mean; softening of pixel std and gradient energy within
   `AUGEQ_SOFTENING`), the same draws through the CPU's plain path
   (card against CPU z printed), and the MixUp gate rate 1.0 on a set
   where every image has labels; (b) `torch_augment_ab.main` with both
   arms at 50 epochs (the learnable set, 96 px, B 4): each arm's
   run-average loss below `AB_LOSS_MAX` and at least one confident
   correct detection, the arms' relative loss gap below `AB_LOSS_GAP`;
   (c) `torch_augment_outcome_ab.main` at `OUTCOME_EPOCHS` (12, cut from
   the script's 150 for time): each arm's loss over its last 10
   iterations before the L1 loss joins below that over its first 10,
   the APs and their deltas printed (at 150 epochs neither package
   detects anything on the noise images: AP 0). The launch counters are read around each
   arm, each iteration (K5 once a device-augmented step and never
   otherwise, `shear_x`, K3 and K4 never), each detection and
   evaluation (K2 at least once); each arm's img/s; the phase's wall
   time. (b) and (c) train under PyTorch's default TF32 settings, as the
   scripts run alone (`torch_default_tf32`), and deterministically.

18. (run last) the model zoo (`run_zoo`): yolox-tiny (416 px), -m, -l
   and -x (640 px) at full width and depth from seeded weights (scores
   spread), each: `Yolox.__call__` at B 1 and 2 in float32 against the
   CPU module with the same weights (`assert_detections_match`), bf16
   against the card's float32 (`bf16_rows_match`), K1 and K2 once a
   call; serve latency (B 1) and throughput at `bench.py`'s serve batch
   (256 / 128 / 96 / 32) in float32 and bf16 (CUDA events, device ms,
   peak memory); K1 at the model's stem width (24 / 48 / 64 / 80) against
   its plain version at B 1 and the serve batch, uint8 to float32 and
   bf16, with its times, bound and cuDNN yardstick; Q1 against its plain
   version at every int8 conv shape (B 32), int8 HBM serving at B 32
   from the bf16 module with the launches read around it (Q1 once per
   BaseConv, K1 and K2 once), its first image against the CPU's int8
   serve at phase 11's tolerances, Q1's times over the call; K3 and
   K4 against their plain versions at every distinct 1x1 SiLU shape (B
   8, float32 and bf16), the fused step against autograd at B 2 on one
   held SimOTA assignment with the float64 autograd step as the arbiter
   (`ZOO_F32_SLACK`), the bf16 `fused_bwd` step at `bench.py`'s train
   batch (64 / 48 / 32 / 16; a batch that does not fit is recorded and
   halved) with K3 / K4 once per 1x1 SiLU conv a step and finite losses,
   step times, kernel ms and peak memory, K3 / K4 replayed over the step
   beside their yardsticks; for tiny one device-augmented step (mosaic
   scale 0.5-1.5, no MixUp; K5 once). One JSON line a model.

Then JSON lines with the serve, evaluation, training, augmentation,
int8, trainer, CLI, parallel, mesh, harness, profiler, A/B and zoo
results and the kernels (each with its launches on every main path:
`launches`, `launches_eval`, `launches_trainer`, `launches_cli`,
`launches_parallel`, `launches_mesh`, `launches_harness`,
`launches_profile`, `launches_ab`, `launches_zoo`), each phase's
wall time, the `nvidia-smi` name and power limit, and as the last line
`{"ok": true, "device": {...}}`.

TF32 is turned off here (cuDNN and matmul) before any comparison with
float32 references; the package itself never changes global flags.
The helpers above `main` import nothing at module level beyond numpy, so
the CPU tests use them too.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"

# NVIDIA H100 SXM data sheet, dense: float32 on CUDA cores, bf16 on tensor
# cores, HBM3 bandwidth
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES = 3.35e12
# float32 operations per element of the BN-backward epilogue: z_hat (2),
# a (2), sigmoid (3), SiLU' (4), g_a (1); K3 adds two sums (3), K4's g_z
# three more (4)
K3_OPS = 15
K4_EPI_OPS = 16
# SM boost clock of the H100 SXM (data sheet): K2's serial floor counts
# one cycle a walked box
H100_CLOCK_HZ = 1.98e9
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
    """(boxes (7, k, 4) float32, valid (7, k) bool) of cases where IoU
    formulas part ways: identical boxes; zero-area boxes; boxes touching
    along an edge or at a corner; negative extents; pairs with IoU exactly
    0.5; an all-invalid row; and a chain (box i overlaps i + 1 at IoU 0.5
    and i + 2 at 0.2), whose greedy result depends on every earlier
    decision."""
    rng = np.random.default_rng(11)
    boxes = np.zeros((7, k, 4), np.float32)
    valid = np.ones((7, k), bool)
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
    x = np.arange(k, dtype=np.float32) * 10                     # chain
    boxes[6] = np.stack([x, np.zeros(k), x + 30, np.full(k, 10)], 1)
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
    read once, each output byte written once; 2 * 108 operations per
    output value at the bf16 tensor-core rate (the work, whatever unit a
    kernel runs it on)."""
    ho, wo = h // 2, w // 2
    nbytes = b * h * w * 3 * in_bytes + b * c * ho * wo * out_bytes \
        + c * (108 + 2) * 4
    flops = 2 * 108 * c * ho * wo * b
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, flops / H100_BF16_FLOPS
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


def walk_floor_ms(valid):
    """K2's serial floor (ms) and the boxes it walks: the greedy walk takes
    one dependent step a box up to each image's last valid one, at least
    one clock cycle of an SM (`H100_CLOCK_HZ`) each; images walk in
    parallel, so the longest walk counts."""
    v = np.asarray(valid)
    n = np.where(v.any(1), v.shape[1] - np.argmax(v[:, ::-1], 1), 0)
    return 1e3 * float(n.max()) / H100_CLOCK_HZ, int(n.max())


# K2's timed cases: (name, batch, max_det, score threshold or None for the
# serve threshold). Serving hands K2 the top 1024 candidates above the
# request's threshold; evaluation (`YoloxConfig.test_conf` 0.01) the top
# max_det above 0.01, nearly all of them valid at 1024.
NMS_CASES = (("serve_b1", 1, 1024, None), ("serve_b32", 32, 1024, None),
             ("eval_b1", 1, 1024, 0.01), ("eval_b32", 32, 1024, 0.01),
             ("k2048_b1", 1, 2048, 0.01), ("k4096_b1", 1, 4096, 0.01),
             ("k8400_b1", 1, 8400, 0.01), ("k8400_b32", 32, 8400, 0.01))


def nms_cases(module, threshold, frames):
    """{case: (boxes, valid)}: the class-offset candidates that
    `YoloxModule.serve` hands K2 for the first B of `frames` (uint8, 640
    px, 8400 anchors) at each of `NMS_CASES`."""
    return {name: serve_candidates(module, frames[:b],
                                   threshold if conf is None else conf, k)
            for name, b, k, conf in NMS_CASES}


def conv_bwd_case(seed, b, ci, co, h, w, dtype, device):
    """Inputs of K3 and K4 for one 1x1 conv: x and W random from `seed`,
    z = conv(x, W) with the BN statistics of that forward (mean, inv),
    gamma and beta near 1 and 0, g_y random."""
    import torch

    rng = np.random.default_rng(seed)
    # the activations are drawn on `device`: at the largest multiscale
    # shapes host draws would take longer than the checks
    gen = torch.Generator(device).manual_seed(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    x = normal(b, ci, h, w)
    wt = t(rng.uniform(-1, 1, (co, ci)) / np.sqrt(ci)).to(dtype)
    # contiguous, as the conv's forward leaves it (einsum may not)
    z = torch.einsum("oi,bihw->bohw", wt.float(), x.float()).to(
        dtype).contiguous()
    mean = z.float().mean((0, 2, 3))
    inv = torch.rsqrt(((z.float() - mean[:, None, None]) ** 2).mean((0, 2, 3))
                      + 1e-3)
    return {"x": x, "w": wt, "z": z, "mean": mean, "inv": inv,
            "gamma": t(1.0 + 0.3 * rng.standard_normal(co)),
            "beta": t(0.1 * rng.standard_normal(co)),
            "g_y": normal(b, co, h, w)}


# Tolerances of K3 / K4 against their plain versions, relative to the sum
# of |terms| of each output (per channel for K3): float32 sums in another
# order (K3 and the dgrad chain at most a few hundred terms a thread, the
# split-K wgrad up to ~1300); bf16 outputs one bf16 rounding of their own
# plus one of g_z (rounded to bf16 before both products) per term.
K3_TOL = 2e-5
K4_DGRAD_TOL = 2e-5
K4_WGRAD_TOL = 1e-4


def check_conv_bwd(case):
    """K3 and K4 on `case` against their plain versions. Returns {"k3",
    "k4"}: (max abs error, max error over its tolerance); fails when the
    latter exceeds 1."""
    import torch

    from yolox_tpu_torch.ops import conv_bwd as cb

    x, w, z, g_y = case["x"], case["w"], case["z"], case["g_y"]
    gamma, beta, mean, inv = (case[k] for k in ("gamma", "beta", "mean",
                                                "inv"))
    n = z.shape[0] * z.shape[2] * z.shape[3]
    bf16 = x.dtype == torch.bfloat16

    def ch(v):
        return v[None, :, None, None]

    got, table = cb.reduce_sums(z, g_y, gamma, beta, mean, inv, coeff=True)
    want = cb.reduce_sums_plain(z, g_y, gamma, beta, mean, inv)
    zh = (z.float() - ch(mean)) * ch(inv)
    a = zh * ch(gamma) + ch(beta)
    s = torch.sigmoid(a)
    ga = g_y.float() * s * (1 + a * (1 - s))
    terms = torch.stack([ga.abs().sum((0, 2, 3)),
                         (ga * zh).abs().sum((0, 2, 3))])
    d3 = (got - want).abs()
    k3 = (d3.max().item(), (d3 / (K3_TOL * terms + 1e-30)).max().item())

    # the kernel's table: the torch expressions on its own sums
    d_tab = (table - cb.coeff_table(got, n, gamma, beta, mean, inv)).abs()
    if not bool((d_tab <= 1e-6 * table.abs()).all()):
        raise AssertionError(f"K3's coefficient table is off by "
                             f"{d_tab.max().item():.3g}")
    coeff = cb.coeff_table(want, n, gamma, beta, mean, inv)
    gx, gw = cb.main_1x1(x, z, g_y, w, coeff)
    gx_p, gw_p = cb.main_1x1_plain(x, z, g_y, w, coeff)
    g_z = (ch(gamma * inv) * (ga - ch(want[0] / n) - zh * ch(want[1] / n))
           ).to(x.dtype).float()
    tx = torch.einsum("oi,bohw->bihw", w.float().abs(), g_z.abs())
    tw = torch.einsum("bohw,bihw->oi", g_z.abs(), x.float().abs())
    dx = (gx.float() - gx_p.float()).abs()
    dw = (gw - gw_p).abs()
    if bf16:
        lim_x = 2.0 ** -7 * gx_p.float().abs() + 2.0 ** -8 * tx
        lim_w = (2.0 ** -8 + K4_WGRAD_TOL) * tw
    else:
        lim_x, lim_w = K4_DGRAD_TOL * tx, K4_WGRAD_TOL * tw
    k4 = (max(dx.max().item(), dw.max().item()),
          max((dx / (lim_x + 1e-30)).max().item(),
              (dw / (lim_w + 1e-30)).max().item()))
    torch.cuda.synchronize()
    if k3[1] > 1 or k4[1] > 1:
        raise AssertionError(f"K3 / K4 disagree with their plain versions: "
                             f"K3 {k3}, K4 {k4}")
    return {"k3": k3, "k4": k4}


def conv_bwd_bounds(b, ci, co, hw, elt_bytes, bf16):
    """Least times of K3 and K4 on an H100 for one 1x1 conv, as {"k3",
    "k4"}: (ms for the bytes, ms for the operations); the bound is the
    larger. Each input is read once and each output written once; K4's two
    products (2 * 2 * N * Ci * Co) run at the bf16 tensor-core or the
    float32 CUDA-core peak, the f32 epilogues at the CUDA-core peak."""
    n = b * hw
    k3_bytes = 2 * n * co * elt_bytes + 6 * co * 4
    k4_bytes = ((2 * n * ci + 2 * n * co + ci * co) * elt_bytes
                + 7 * co * 4 + ci * co * 4)
    k4_ops = (4 * n * ci * co / (H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)
              + K4_EPI_OPS * n * co / H100_F32_FLOPS)
    return {"k3": (1e3 * k3_bytes / H100_HBM_BYTES,
                   1e3 * K3_OPS * n * co / H100_F32_FLOPS),
            "k4": (1e3 * k4_bytes / H100_HBM_BYTES, 1e3 * k4_ops)}


def synthetic_labels(rng, b, size=640, max_labels=120, num_classes=80):
    """(b, max_labels, 5) rows (cls, cx, cy, w, h): 1-30 boxes an image,
    sides 16 px to half the image, inside it; zero rows pad."""
    labels = np.zeros((b, max_labels, 5), np.float32)
    for i in range(b):
        n = int(rng.integers(1, 31))
        w, h = rng.uniform(16, size / 2, (2, n))
        labels[i, :n] = np.stack([
            rng.integers(0, num_classes, n), rng.uniform(w / 2, size - w / 2),
            rng.uniform(h / 2, size - h / 2), w, h], 1)
    return labels


def kernel_conv_shapes(module, size=640):
    """(Ci, Co, H, W) of every BaseConv that takes K3 and K4 in a training
    step (1x1, stride 1, groups 1, SiLU), in forward order, read with hooks
    from one eval forward of a 1-image batch."""
    import torch

    from yolox_tpu_torch.models.blocks import BaseConv
    from yolox_tpu_torch.ops.conv_bwd import uses_kernels

    shapes, hooks = [], []
    for m in module.modules():
        if isinstance(m, BaseConv) and uses_kernels(
                m.conv.kernel_size[0], m.conv.stride[0], m.conv.groups,
                m.act_name):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: shapes.append(
                    (args[0].shape[1], mod.conv.out_channels)
                    + tuple(args[0].shape[2:]))))
    try:
        module(np.zeros((1, size, size, 3), np.uint8))
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return shapes


def tensors_close(got, want, tol):
    """max over tensors of max |got - want| over `tol` times the largest
    |want| entry among all of them (0 when every tensor agrees)."""
    scale = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k].float() - want[k].float()).abs().max())
               for k in want) / (tol * scale)


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


def queued_ms(fn, reps=5):
    """Device time of fn() per call from CUDA events, with the calls
    queued behind a spin kernel (~25 ms) so that the host's time between
    launches does not show: their kernels run back to back."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


# K1 on the tensor cores (uint8 and bf16 images): the tensor core sums a
# k step's products by aligning them to the largest and truncating, up to
# ~2 ulp of a step's magnitude for each of the 7 k steps (the kernel adds
# the steps with IEEE adds), so K1's float32 sum may stray by up to 2^-19
# of its sum of |x w|; times |scale| and the activation's largest slope
# (1.1, SiLU), this is added to the output tolerances below. It matters
# near zero, where one bf16 ulp of the output is tiny.
K1_TC_TOL = 2.0 ** -19


def stem_limit(x, wb, scale, ref, out_dtype, tensor_core=True):
    """K1's tolerance for each output: float32 out `F32_ATOL` + `F32_RTOL`
    |ref|, bf16 out one bf16 ulp (`BF16_ULP` |ref| + 1e-6); for uint8 and
    bf16 images, which take the tensor cores (unless `tensor_core` is
    False), plus `K1_TC_TOL` times 1.1 |scale| sum |x w|."""
    import torch
    import torch.nn.functional as F

    if out_dtype == torch.float32:
        lim = F32_ATOL + F32_RTOL * ref.abs()
    else:
        lim = BF16_ULP * ref.abs() + 1e-6
    if tensor_core and x.dtype != torch.float32:
        sxw = F.conv2d(x.permute(0, 3, 1, 2).float().abs(), wb.abs(),
                       stride=2, padding=2)
        lim = lim + K1_TC_TOL * 1.1 * scale.abs()[:, None, None] * sxw
    return lim


def check_stem(x, wb, scale, bias, act, out_dtype):
    """K1 on one input against its plain version at `stem_limit`.
    Returns (max abs error, max error over its tolerance, the same over
    the tolerance without the tensor-core term); fails past 1."""
    import torch

    from yolox_tpu_torch.ops.stem import (
        stem_conv_bn_act,
        stem_conv_bn_act_plain,
    )

    got = stem_conv_bn_act(x, wb, scale, bias, act, out_dtype).float()
    ref = stem_conv_bn_act_plain(x, wb, scale, bias, act, out_dtype).float()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    r = (err.max().item(),
         (err / stem_limit(x, wb, scale, ref, out_dtype)).max().item(),
         (err / stem_limit(x, wb, scale, ref, out_dtype, False)).max().item())
    if not r[1] <= 1:
        raise AssertionError(f"K1 disagrees with its plain version: {r}")
    return r


def phase_stem(rng, wb, scale, bias):
    """K1 against its plain version at C 32 (yolox-s) and 80 (yolox-x),
    B 1 and 8, 640 px, uint8 / float32 / bf16 images, float32 / bf16
    outputs, float32 weights and bf16-exact ones (a bf16 model's); returns
    the float32-output max error at C 32."""
    import torch

    f32_err = 0.0
    c80 = torch.from_numpy(rng.uniform(-0.1, 0.1, (80, 3, 6, 6)).astype(
        np.float32)).cuda()
    s80 = torch.from_numpy(rng.uniform(0.5, 1.5, 80).astype(np.float32)).cuda()
    b80 = torch.from_numpy(rng.uniform(-1, 1, 80).astype(np.float32)).cuda()
    for c, (w, s, bi) in ((32, (wb, scale, bias)), (80, (c80, s80, b80))):
        for b in (1, 8):
            img = torch.from_numpy(
                rng.integers(0, 256, (b, 640, 640, 3), dtype=np.uint8)).cuda()
            for x in (img, img.float(), img.bfloat16()):
                for wname, wt in (("f32 w", w),
                                  ("bf16 w", w.bfloat16().float())):
                    for out_dtype in (torch.float32, torch.bfloat16):
                        err, rel, rel0 = check_stem(x, wt, s, bi, "silu",
                                                    out_dtype)
                        if out_dtype == torch.float32 and c == 32:
                            f32_err = max(f32_err, err)
                        log(f"K1 C{c} b{b} {x.dtype} {wname} -> {out_dtype}: "
                            f"max |d| {err:.3g}, {rel:.3g} of its tolerance "
                            f"({rel0:.3g} without the tensor-core term)")
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


# (h, w) of the serving frames whose letterbox ratio is not 1
ODD_FRAMES = ((720, 1280), (375, 500))


class hidden_cv2:
    """Within the block `import cv2` fails in this process and in the
    worker processes it forks, so `data/cv2_compat.py` runs its numpy
    versions (the route of a host without cv2)."""

    def __enter__(self):
        self.saved = sys.modules.get("cv2", self)
        sys.modules["cv2"] = None

    def __exit__(self, *exc):
        if self.saved is self:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = self.saved


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

    # 640 x 640 frames letterbox to themselves; a 1280 x 720 and a 500 x
    # 375 frame do not (ratios 0.5 and 1.28), so their letterbox resizes
    # through `data/cv2_compat.py` (numpy on a host without cv2); each
    # request's threshold sits in a gap of the CPU's scores, so both
    # devices keep the same candidates (scores agree to ~1e-5 relative)
    from yolox_tpu_torch.data import cv2_compat

    odd = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
           for h, w in ODD_FRAMES]
    requests = [_frames(rng, n) for n in (1, 3, 8)] + [odd]
    stream_in = _frames(rng, 10)
    log(f"letterbox resize route on this host: {cv2_compat.route()}")
    cuts = [gap_threshold(anchor_scores(cpu_mod, cpu.processor(
        f, dtype=np.uint8)), 0.25, 0.45) for f in requests + [stream_in]]
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
    with hidden_cv2():
        route = cv2_compat.route()
        assert_detections_match(gpu(odd, threshold=thr[3]), got[3])
    log(f"the {ODD_FRAMES} pair through cv2_compat's {route} route gives "
        "the same detections on the card")
    assert_detections_match(got_stream, cpu(stream_in, threshold=thr[-1]))
    assert_detections_match(got_stream[:8],
                            gpu(stream_in[:8], threshold=thr[-1]))
    log(f"Yolox.__call__ (1, 3, 8 frames and the {ODD_FRAMES} pair) and "
        f"stream (10 frames, batch 4) match the CPU: {n_dets} detections "
        "on the calls")

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


def stem_times(rng, wb, scale, bias, size=640, batches=(1, 32)):
    """K1 at each of `batches`, `size` px, uint8 in, float32 and bf16 out
    (bf16 out with bf16-exact weights, as a bf16 model passes them): ms
    from CUDA events (`cuda_ms`), device ms alone (`queued_ms`), plain ms,
    bound, and the cuDNN yardstick (F.conv2d + F.batch_norm + F.silu in
    the output's dtype on an NCHW copy of the image in that dtype, made
    before the timing; timed only) by both clocks. Keys "b1", "b32",
    "b1_bf16", "b32_bf16" (for the default batches)."""
    import torch
    import torch.nn.functional as F

    from yolox_tpu_torch.ops.stem import (
        stem_conv_bn_act,
        stem_conv_bn_act_plain,
    )

    c = wb.shape[0]
    out = {}
    for b in batches:
        img = torch.from_numpy(
            rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)).to(
                wb.device)
        iters = 50 if b == 1 else 10
        for dt in (torch.float32, torch.bfloat16):
            w = wb if dt == torch.float32 else wb.bfloat16().float()
            # F.batch_norm with mean 0, var 1 - eps applies scale / bias
            zeros = torch.zeros(c, device=wb.device, dtype=dt)
            var = torch.full((c,), 1.0 - 1e-3, device=wb.device, dtype=dt)
            x_lib = img.permute(0, 3, 1, 2).to(dt).contiguous()
            w_lib, s_lib, b_lib = w.to(dt), scale.to(dt), bias.to(dt)

            def kernel(w=w, dt=dt):
                return stem_conv_bn_act(img, w, scale, bias, "silu", dt)

            def library(x_lib=x_lib, w_lib=w_lib, s_lib=s_lib, b_lib=b_lib,
                        zeros=zeros, var=var):
                y = F.conv2d(x_lib, w_lib, stride=2, padding=2)
                y = F.batch_norm(y, zeros, var, s_lib, b_lib, False, 0.0,
                                 1e-3)
                return F.silu(y)

            t = {"ms": cuda_ms(kernel, iters),
                 "device_ms": queued_ms(kernel, 20 if b == 1 else 5),
                 "plain_ms": cuda_ms(lambda: stem_conv_bn_act_plain(
                     img, w, scale, bias, "silu", dt), iters),
                 "library_ms": cuda_ms(library, iters),
                 "library_device_ms": queued_ms(library,
                                                20 if b == 1 else 5)}
            t["bound_ms"], t["bound_by"] = stem_bound(
                b, size, size, c, 1, 4 if dt == torch.float32 else 2)
            key = f"b{b}" + ("" if dt == torch.float32 else "_bf16")
            out[key] = t
            log(f"K1 C{c} {key} uint8 -> {dt}: {t}")
            del x_lib
    return out


def phase_times(rng, gpu_mod, wb, scale, bias, threshold):
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    times = {"stem": stem_times(rng, wb, scale, bias), "nms": {},
             "serve": {}}
    # K2 on the candidates yolox-s hands it: serving at B 1 and 32, and
    # evaluation (conf 0.01) at K 1024 to 8400
    frames = rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
    for name, (boxes, valid) in nms_cases(gpu_mod, threshold,
                                          frames).items():
        b, k = valid.shape
        t = {"ms": cuda_ms(lambda: nms_keep(boxes, valid, 0.65), 50),
             "device_ms": queued_ms(lambda: nms_keep(boxes, valid, 0.65),
                                    20),
             # the plain version's (B, K, K) IoU past 2 GB is not timed
             "plain_ms": cuda_ms(lambda: nms_keep_plain(boxes, valid, 0.65),
                                 2, warmup=1)
             if b * k * k * 4 <= 2 << 30 else None,
             "library_ms": None, "library_device_ms": None}
        vnp = valid.cpu().numpy()
        t["bound_ms"], t["bound_by"] = nms_bound(vnp)
        t["walk_floor_ms"], walked = walk_floor_ms(vnp)
        t["device_ms_per_walked_box"] = t["device_ms"] / max(walked, 1)
        t.update(B=b, K=k, valid=int(vnp.sum()), walked=walked)
        times["nms"][name] = t
        log(f"K2 {name}: {t}")

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
    """Device time of one serve call by kernel (`device_time`)."""
    def serve():
        dets, valid = module.serve(x, conf_thre=threshold, max_det=1024)
        dets.cpu(), valid.cpu()

    return device_time(serve, reps)


def device_time(fn, reps=2):
    """Device time of fn() by kernel, from torch.profiler (CUPTI), after
    one unprofiled call: (device ms per call, [(kernel, ms per call), ...]
    largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        # device-side events only: an aten op repeats its kernels' time
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.self_device_time_total
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t / 1e3 / reps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return sum(per_kernel.values()), top


def serve_candidates(module, img, threshold, max_det=1024):
    """The class-offset candidate boxes and valid mask that serve hands K2
    for this batch."""
    import torch

    from yolox_tpu_torch.ops import nms as nms_ops

    captured = {}
    real = nms_ops.nms_keep

    def spy(boxes, valid, thr):
        captured["args"] = (boxes.clone(), valid.clone())
        return real(boxes, valid, thr)

    nms_ops.nms_keep = spy
    try:
        module.serve(img, conf_thre=threshold, max_det=max_det)
    finally:
        nms_ops.nms_keep = real
    torch.cuda.synchronize()
    return captured["args"]


# --------------------------------------------------------- training phases

TRAIN_B = 16
# the card's fused step against its autograd step, and the card's B 2
# step against the CPU's: gradients and updates within this share of the
# largest entry of their kind, losses at this relative tolerance. float32
# 1-ulp differences of conv sums grow ~1e3x through the train-mode BN
# layers at random init (`tests/test_torch_train.py` holds the port to
# JAX on the CPU at the same scaled tolerance)
TRAIN_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-3


def _launch_counters():
    from yolox_tpu_torch.ops.conv_bwd import main_1x1, reduce_sums
    from yolox_tpu_torch.ops.int8_conv import int8_conv, int8_dwconv
    from yolox_tpu_torch.ops.nms_kernel import nms_keep
    from yolox_tpu_torch.ops.shear_kernel import shear_x, shear_xy
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    return {"reduce_sums": reduce_sums, "main_1x1": main_1x1,
            "stem": stem_conv_bn_act, "nms": nms_keep, "shear_x": shear_x,
            "shear_xy": shear_xy, "int8_conv": int8_conv,
            "int8_dwconv": int8_dwconv}


def phase_conv_bwd(shapes, multiscale):
    """K3 and K4 against their plain versions at every shape of a 640 px
    step and at the distinct `multiscale` shapes (those of every other
    size `random_resize` draws, 480-800 px: HW 225, 625, 900 and others
    are no multiple of 8), B 16, float32 and bf16. Returns the float32
    max abs errors {"k3", "k4"}."""
    import torch

    errs, worst = {"k3": 0.0, "k4": 0.0}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (ci, co, h, w) in enumerate(list(shapes) + list(multiscale)):
            r = check_conv_bwd(conv_bwd_case(100 + i, TRAIN_B, ci, co, h, w,
                                             dtype, "cuda"))
            for k in ("k3", "k4"):
                if dtype == torch.float32:
                    errs[k] = max(errs[k], r[k][0])
                worst[f"{k} {name}"] = max(worst.get(f"{k} {name}", 0.0),
                                           r[k][1])
    log(f"K3 / K4 match their plain versions at all {len(shapes)} shapes "
        f"and {len(multiscale)} multiscale shapes (B {TRAIN_B}): float32 max abs error K3 {errs['k3']:.3g}, K4 "
        f"{errs['k4']:.3g}; worst error over tolerance "
        + json.dumps({k: round(v, 4) for k, v in worst.items()}))
    return errs


def phase_train(cfg, x, labels, n_kernel_convs):
    """The main training path: 3 fused steps in float32 and 3 in bf16 from
    seeded yolox-s, the launch counters set to 0 just before each step and
    read just after. Returns the launches over the 6 steps."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import init_train_state, make_train_step

    counters = _launch_counters()
    want = {"reduce_sums": n_kernel_convs, "main_1x1": n_kernel_convs,
            "stem": 0, "nms": 0, "shear_x": 0, "shear_xy": 0,
            "int8_conv": 0, "int8_dwconv": 0}
    total = dict.fromkeys(counters, 0)
    for dtype in (torch.float32, torch.bfloat16):
        module = YoloxModule.from_config(cfg, rng_seed=4321)
        state = init_train_state(module)
        step = make_train_step(module, cfg.num_classes, compute_dtype=dtype,
                               fused_bwd=True)
        for i in range(3):
            torch.cuda.synchronize()
            for f in counters.values():
                f.launches = 0
            state, losses = step(state, x, labels, 0.01)
            torch.cuda.synchronize()
            n = {k: f.launches for k, f in counters.items()}
            vals = {k: round(float(v), 5) for k, v in losses.items()}
            log(f"train step {i} {str(dtype).split('.')[-1]} fused: "
                f"launches {n} losses {vals}")
            if n != want:
                raise AssertionError(f"a training step launched {n}, want "
                                     f"{want}")
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError("a training step gave a non-finite loss")
            for k in total:
                total[k] += n[k]
    return total


def _held_step(module, x, labels, assignment, fused, num_classes,
               compute_dtype=None):
    """One float32 (or `compute_dtype`) step without EMA on a held
    assignment: (losses, gradients as the first step's momentum buffers,
    parameter updates)."""
    from yolox_tpu_torch.core import init_train_state, make_train_step

    state = init_train_state(module, use_ema=False)
    step = make_train_step(module, num_classes, use_ema=False,
                           fused_bwd=fused,
                           **({} if compute_dtype is None
                              else {"compute_dtype": compute_dtype}))
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    state, losses = step(state, x, labels, 0.01, assignment=assignment)
    grads = {n: state.optimizer.state[p]["momentum_buffer"]
             for n, p in module.named_parameters()}
    updates = {n: p.detach() - before[n] for n, p in module.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads, updates


def _assignment(module, x, labels, num_classes):
    """SimOTA on a train-mode forward of a copy of `module` (its BN
    statistics stay as they are)."""
    import copy

    import torch

    from yolox_tpu_torch.models.assign import assign_batch

    dev = module.device
    with torch.no_grad():
        head = copy.deepcopy(module).train().forward_train(
            torch.as_tensor(x).to(dev))
        return assign_batch(head, torch.as_tensor(labels).to(dev),
                            num_classes)


def _losses_close(got, want):
    return max(abs(got[k] - want[k]) / (TRAIN_LOSS_RTOL * max(abs(want[k]),
                                                              1e-12))
               for k in want)


def phase_train_parity(cfg, x, labels):
    """With one assignment held fixed: the fused step's gradients against
    the autograd step's on the card (B 16), and one B 2 step on the card
    against the CPU's (plain versions)."""
    import copy

    import torch

    from yolox_tpu_torch import YoloxModule

    base = YoloxModule.from_config(cfg, rng_seed=4321)
    xg, lg = torch.from_numpy(x).cuda(), torch.from_numpy(labels).cuda()
    held = _assignment(base, xg, lg, cfg.num_classes)
    l_f, g_f, _ = _held_step(copy.deepcopy(base), xg, lg, held, True,
                             cfg.num_classes)
    l_a, g_a, _ = _held_step(copy.deepcopy(base), xg, lg, held, False,
                             cfg.num_classes)
    r_grad = tensors_close(g_f, g_a, TRAIN_TOL)
    r_loss = _losses_close(l_f, l_a)
    log(f"held assignment ({int(held['num_fg'].sum())} fg): fused vs autograd "
        f"step on the card, gradients at {r_grad:.3g} and losses at "
        f"{r_loss:.3g} of their tolerances; total_loss {l_f['total_loss']:.6f}"
        f" vs {l_a['total_loss']:.6f}")
    if r_grad > 1 or r_loss > 1:
        raise AssertionError("the fused step's gradients disagree with "
                             "autograd's")

    cpu = YoloxModule.from_config(cfg, rng_seed=4321, device="cpu")
    gpu = YoloxModule.from_config(cfg, rng_seed=4321)
    held = _assignment(cpu, x[:2], labels[:2], cfg.num_classes)
    t0 = time.perf_counter()
    l_c, _, u_c = _held_step(cpu, x[:2], labels[:2], held, True,
                             cfg.num_classes)
    cpu_s = time.perf_counter() - t0
    l_g, _, u_g = _held_step(gpu, x[:2], labels[:2],
                             {k: v.cuda() for k, v in held.items()}, True,
                             cfg.num_classes)
    r_upd = tensors_close({k: v.cpu() for k, v in u_g.items()}, u_c, TRAIN_TOL)
    r_loss = _losses_close(l_g, l_c)
    log(f"B 2 step, card vs CPU ({cpu_s:.1f} s on the CPU): updates at "
        f"{r_upd:.3g} and losses at {r_loss:.3g} of their tolerances; "
        f"total_loss {l_g['total_loss']:.6f} vs {l_c['total_loss']:.6f}")
    if r_upd > 1 or r_loss > 1:
        raise AssertionError("the card's training step disagrees with the "
                             "CPU's")


def _event_ms(fn, reps):
    """Per-call CUDA-event times of fn() after 2 warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return samples


def phase_train_times(cfg, x, labels):
    """Median B 16 step time (CUDA events, after 2 warm-up steps) for
    float32 and bf16, `fused_bwd` on and off; device busy share and peak
    memory beside each."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import init_train_state, make_train_step

    xg, lg = torch.from_numpy(x).cuda(), torch.from_numpy(labels).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for fused in (True, False):
            module = YoloxModule.from_config(cfg, rng_seed=4321)
            state = init_train_state(module)
            step = make_train_step(module, cfg.num_classes,
                                   compute_dtype=dtype, fused_bwd=fused)
            torch.cuda.reset_peak_memory_stats()
            samples = _event_ms(lambda: step(state, xg, lg, 0.01), 5)
            med = float(np.median(samples))
            key = (f"{str(dtype).split('.')[-1]}_"
                   f"{'fused' if fused else 'autograd'}")
            out[key] = {"median_ms": med, "img_per_s": 1e3 * TRAIN_B / med,
                        "samples_ms": samples,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            dev_ms, top = device_time(lambda: step(state, xg, lg, 0.01))
            if top:
                out[key]["device_ms"] = dev_ms
                out[key]["device_busy"] = dev_ms / med
            log(f"train step {key} B {TRAIN_B}: {out[key]}; device kernels "
                "(ms per step): "
                + json.dumps([(k[:60], round(v, 3)) for k, v in top[:8]]))
            del module, state, step
            torch.cuda.empty_cache()
    return out


def conv_bwd_calls(c):
    """K3, K4 and their library yardsticks on one `conv_bwd_case` as
    calls without arguments ("k3", "k4", "k3_lib", "k4_lib"), with the
    coefficient table K4 takes ("coeff"). K3's yardstick,
    `native_batch_norm_backward`, computes grad_input as well: more work
    than K3. K4's, cuDNN's two products, takes g_z as given: less work
    than K4."""
    import torch

    from yolox_tpu_torch.ops import conv_bwd as cb

    def ch(v):
        return v[None, :, None, None]

    x, wt, z, g_y = c["x"], c["w"], c["z"], c["g_y"]
    gamma, beta, mean, inv = c["gamma"], c["beta"], c["mean"], c["inv"]
    n = z.shape[0] * z.shape[2] * z.shape[3]
    s, coeff = cb.reduce_sums(z, g_y, gamma, beta, mean, inv, coeff=True)
    zh = (z.float() - ch(mean)) * ch(inv)
    ga = g_y.float() * cb.act_grad("silu", zh * ch(gamma) + ch(beta))
    g_z = (ch(gamma * inv) * (ga - ch(s[0] / n) - zh * ch(s[1] / n))
           ).to(x.dtype)
    ga = ga.to(x.dtype)
    w4 = wt[:, :, None, None]
    del zh
    return {
        "coeff": coeff,
        "k3": lambda: cb.reduce_sums(z, g_y, gamma, beta, mean, inv,
                                     coeff=True),
        "k4": lambda: cb.main_1x1(x, z, g_y, wt, coeff),
        "k3_lib": lambda: torch.ops.aten.native_batch_norm_backward(
            ga, z, gamma, None, None, mean, inv, True, 1e-3,
            [True, True, True]),
        "k4_lib": lambda: (torch.nn.grad.conv2d_input(x.shape, w4, g_z),
                           torch.nn.grad.conv2d_weight(x, w4.shape, g_z))}


def conv_bwd_times(shapes):
    """K3 and K4 at every shape (B 16): ms per launch from CUDA events
    around 20 back-to-back calls (host or device, whichever is slower), the
    device ms alone of the kernels and, timed alike, of the library
    yardsticks (per shape `queued_ms`; per step also their time in
    torch.profiler, `device_ms` and `library_device_ms` of "per_step"),
    plain ms and bound, per dtype; with the per-step sums and the
    entries at the largest and the most frequent shape. K3 is timed as
    the fused backward calls it (with K4's coefficient table)."""
    import collections

    import torch

    from yolox_tpu_torch.ops import conv_bwd as cb

    freq = collections.Counter(shapes).most_common(1)[0][0]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        rows = []
        calls = {"k3": [], "k4": [], "k3_lib": [], "k4_lib": []}
        for i, (ci, co, h, w) in enumerate(shapes):
            c = conv_bwd_case(200 + i, TRAIN_B, ci, co, h, w, dtype, "cuda")
            x, wt, z, g_y = c["x"], c["w"], c["z"], c["g_y"]
            gamma, beta, mean, inv = c["gamma"], c["beta"], c["mean"], c["inv"]
            fns = conv_bwd_calls(c)
            coeff = fns["coeff"]
            k3, k4, lib3, lib4 = (fns[k] for k in ("k3", "k4", "k3_lib",
                                                   "k4_lib"))
            for k in calls:
                calls[k].append(fns[k])
            # the small shapes are host-bound: 20 calls in a row average
            # out the host's jitter, the same for all three
            iters = 20
            r = {"shape": (ci, co, h, w)}
            r["k3"] = {
                "ms": cuda_ms(k3, iters),
                "plain_ms": cuda_ms(lambda: cb.reduce_sums_plain(
                    z, g_y, gamma, beta, mean, inv), iters),
                "library_ms": cuda_ms(lib3, iters)}
            r["k4"] = {
                "ms": cuda_ms(k4, iters),
                "plain_ms": cuda_ms(lambda: cb.main_1x1_plain(
                    x, z, g_y, wt, coeff), iters),
                "library_ms": cuda_ms(lib4, iters)}
            # device time alone, kernel and library timed alike
            for k, f, lib in (("k3", k3, lib3), ("k4", k4, lib4)):
                r[k]["device_ms"] = queued_ms(f)
                r[k]["library_device_ms"] = queued_ms(lib)
            bounds = conv_bwd_bounds(TRAIN_B, ci, co, h * w,
                                     x.element_size(), bf16)
            for k in ("k3", "k4"):
                t_b, t_o = bounds[k]
                r[k]["bound_ms"] = max(t_b, t_o)
                r[k]["bound_by"] = "bytes" if t_b >= t_o else "operations"
            rows.append(r)
            del fns
        name = str(dtype).split(".")[-1]
        out[name] = {}
        for k in ("k3", "k4"):
            keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                    "library_device_ms")
            total = {q: sum(r[k][q] for r in rows) for q in keys}
            total["queued_device_ms"] = total.pop("device_ms")
            total["queued_library_device_ms"] = total.pop("library_device_ms")
            # the kernels' own time, one step's launches in a row; the
            # library's the same way
            total["device_ms"], top = device_time(
                lambda: [f() for f in calls[k]], 3)
            total["library_device_ms"], lib_top = device_time(
                lambda: [f() for f in calls[k + "_lib"]], 3)
            total["library_kernels"] = [(e[:40], round(v, 4))
                                        for e, v in lib_top[:4]]
            by_bytes = sum(r[k]["bound_ms"] for r in rows
                           if r[k]["bound_by"] == "bytes")
            total["bound_by"] = ("bytes" if by_bytes >= total["bound_ms"] / 2
                                 else "operations")
            total["device_kernels"] = [(e[:40], round(v, 4)) for e, v in top]
            work = (lambda r: r["shape"][1] * r["shape"][2] * r["shape"][3]) \
                if k == "k3" else (lambda r: np.prod(r["shape"]))
            big = max(range(len(rows)), key=lambda j: work(rows[j]))
            common = next(j for j, r in enumerate(rows) if r["shape"] == freq)
            out[name][k] = {
                "per_step": total,
                "largest": {"shape": rows[big]["shape"], **rows[big][k]},
                "most_frequent": {"shape": freq,
                                  "count": shapes.count(freq),
                                  **rows[common][k]}}
            log(f"K{3 if k == 'k3' else 4} {name} B {TRAIN_B}: "
                + json.dumps(out[name][k]))
            log(f"K{3 if k == 'k3' else 4} {name} device ms by shape "
                "(kernel, library, bound): "
                + json.dumps([(r["shape"], round(r[k]["device_ms"], 4),
                               round(r[k]["library_device_ms"], 4),
                               round(r[k]["bound_ms"], 4)) for r in rows]))
        del calls, rows
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------- augmentation phases

# the card's augmentation against the CPU's on the same draws. The card
# runs the interpolation products and the buffers between passes in bf16
# (the CPU in float32): before HSV a pixel carries at most 8 bf16
# roundings of values below 256 (0.5 each: the first product's output, its
# and the second product's weights, h1, the border term and its sum, the
# two shear passes), so it moves by at most 4.0 levels, the bound the JAX
# package's bf16 test uses (`tests/test_device_augment.py`). HSV is then
# held separately: the card's HSV of its own pre-HSV image against the
# CPU's HSV of that image (float32 math on both), because the hue of a
# near-gray pixel is ill-conditioned and the saturation gain (up to 30
# levels) turns a 1-level difference there into up to ~20. Labels are
# float32 math on both devices.
AUG_IMG_TOL = 4.0
AUG_HSV_TOL = 1e-2
AUG_LABEL_TOL = 1e-3
# K5 reads at most this |d shift / d row| in the 640 px warp (rotation
# 10 deg + shear 2 x 2 deg: tan(14 deg) = 0.25; the Pallas kernel's limit
# was 3 pixels over 7 rows)
SHEAR_SLOPE = 0.42


def warp_grid(s=640, degrees=10.0, shear=2.0):
    """(margin, working grid rows) of the three-pass warp at out size s."""
    from yolox_tpu_torch.ops.warp import margin_for

    margin = margin_for(s, degrees, shear)
    return margin, ((s + 2 * margin + 63) // 64) * 64


def affine_shifts(rng, b, n, base, slope=SHEAR_SLOPE):
    """(b, n) float32 shifts base + a*(i - base), |a| <= slope per row
    sequence: the form the warp's y- and x-shear passes give K5."""
    a = rng.uniform(-slope, slope, (b, 1))
    return (base + a * (np.arange(n)[None] - base)).astype(np.float32)


def shear_edge_shifts(b, n, k_max):
    """(b, n) float32 shifts at the contract's edges: k_max (the second tap
    reads the last column), k_max + 1.5 and -0.5 (extrapolation), and
    integers (f = 0), in turn."""
    edge = np.array([k_max, k_max + 1.5, -0.5, 0.0, float(k_max // 2),
                     k_max + 1.0], np.float32)
    return np.resize(edge, (b, n)).astype(np.float32)


def shear_bound(rows, out_wl, px, elt_bytes):
    """Least time of K5 on an H100 (ms) and what sets it: each output value
    reads its row's window of out_wl + px values once and is written once,
    plus one float32 shift a row; 4 float32 operations an output value."""
    nbytes = rows * ((2 * out_wl + px) * elt_bytes + 4)
    t_bytes = nbytes / H100_HBM_BYTES
    t_ops = 4 * rows * out_wl / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def shear_xy_bound(shifts_y, shifts_x, r, out_w, px, elt_bytes):
    """Least time of the fused K5 on an H100 (ms) and what sets it: the
    h1t values these shifts read, each once (output row i's taps need
    h2[x, i] for x in [kx_i, kx_i + out_w], and h2[x, i] reads h1t rows
    ky_x + i and ky_x + i + 1), the output written once and the shifts
    read once; 4 float32 operations an h2 value and an output value."""
    sy = np.asarray(shifts_y, np.float32)
    sx = np.asarray(shifts_x, np.float32)
    b, x = sy.shape
    kx = np.clip(np.floor(sx), 0, x - out_w - 2).astype(np.int64)
    xs = np.arange(x)
    need = ((xs[None, None] >= kx[..., None])
            & (xs[None, None] <= kx[..., None] + out_w))   # (B, S, X)
    pad = np.zeros((b, 1, x), bool)
    read = (np.concatenate([need, pad], 1)
            | np.concatenate([pad, need], 1))              # rows i, i + 1
    n_out = b * out_w * out_w * px
    nbytes = ((int(read.sum()) * px + n_out) * elt_bytes
              + 4 * (sy.size + sx.size))
    ops = 4 * (int(need.sum()) * px + n_out)
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def synthetic_tiles(rng, b, size=640, max_labels=60, num_classes=80):
    """Device-augmentation inputs: (tiles (b, 5, size, size, 3) uint8,
    tile_hw (b, 5, 2) float32, labels (b, 5, max_labels, 5) xyxy+cls). Each
    tile holds random pixels over a random true size of at least half the
    tile and 1-30 boxes, zero-padded."""
    tiles = np.zeros((b, 5, size, size, 3), np.uint8)
    hw = rng.integers(size // 2, size + 1, (b, 5, 2)).astype(np.float32)
    labels = np.zeros((b, 5, max_labels, 5), np.float32)
    for i in range(b):
        for t in range(5):
            h, w = (int(v) for v in hw[i, t])
            tiles[i, t, :h, :w] = rng.integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
            n = int(rng.integers(1, min(30, max_labels) + 1))
            bw, bh = rng.uniform(8, w / 2, n), rng.uniform(8, h / 2, n)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            labels[i, t, :n] = np.stack(
                [x1, y1, x1 + bw, y1 + bh,
                 rng.integers(0, num_classes, n)], 1)
    return tiles, hw, labels


def check_shear(name, img, shifts, out_w, px):
    """K5 against its plain version on one input: bit-equal, else fail.
    Returns the max abs difference (0)."""
    import torch

    from yolox_tpu_torch.ops.shear_kernel import shear_x, shear_x_plain

    got = shear_x(img, shifts, out_w, px)
    ref = shear_x_plain(img, shifts, out_w, px)
    torch.cuda.synchronize()
    ok = got.dtype == img.dtype and torch.equal(got, ref)
    err = float((got.float() - ref.float()).abs().max())
    log(f"K5 {name} {tuple(img.shape)} {img.dtype} px {px} -> out_w "
        f"{out_w}: bit-equal {ok} (max |d| {err:.3g})")
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: {name}")
    return err


def check_shear_xy(name, h1t, shifts_y, shifts_x, out_w, px):
    """The fused K5 against its plain version on one input: bit-equal and
    one launch, else fail. Returns the max abs difference (0)."""
    import torch

    from yolox_tpu_torch.ops.shear_kernel import shear_xy, shear_xy_plain

    before = shear_xy.launches
    got = shear_xy(h1t, shifts_y, shifts_x, out_w, px)
    launched = shear_xy.launches - before
    ref = shear_xy_plain(h1t, shifts_y, shifts_x, out_w, px)
    torch.cuda.synchronize()
    ok = got.dtype == h1t.dtype and torch.equal(got, ref) and launched == 1
    err = float((got.float() - ref.float()).abs().max())
    log(f"K5 fused {name} {tuple(h1t.shape)} {h1t.dtype} px {px} -> "
        f"({out_w}, {out_w}): bit-equal {ok} (max |d| {err:.3g}), "
        f"{launched} launch")
    if not ok:
        raise AssertionError(f"the fused K5 disagrees with its plain "
                             f"version: {name}")
    return err


def xy_shifts(rng, kind, b, x, r, s, margin):
    """(shifts_y (b, x), shifts_x (b, s)) float32 numpy for the fused K5:
    "affine" as the warp gives them, "random" without a slope bound and
    past both clamps, "edge" at the contract's edges."""
    if kind == "affine":
        # the warp's: cl * (x - margin) + margin and uu * i + margin
        slope = rng.uniform(-SHEAR_SLOPE, SHEAR_SLOPE, (2, b, 1))
        return (affine_shifts(rng, b, x, margin),
                (margin + slope[1] * np.arange(s)[None]).astype(np.float32))
    if kind == "random":
        return (rng.uniform(-3, r - s + 2, (b, x)).astype(np.float32),
                rng.uniform(-3, x - s + 2, (b, s)).astype(np.float32))
    return shear_edge_shifts(b, x, r - s - 2), shear_edge_shifts(
        b, s, x - s - 2)


def phase_shear(rng):
    """K5 against its plain versions. The fused kernel (`shear_xy`, the
    main path's): the 640 px warp's shape at B 16 (h1t (16, WR, WR*3) ->
    (16, 640, 640*3)) in float32 and bf16 on affine, unbounded random and
    edge shifts, and a ragged size at px 1 and 3. The single-pass kernel
    (`shear_x`): the warp's two pass shapes at B 16 with affine shifts,
    random per-row shifts without a slope bound at px 1 and 3, and the
    edge shifts."""
    import torch

    margin, wr = warp_grid()
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        img = torch.from_numpy(rng.uniform(0, 255, (TRAIN_B, wr, wr * 3))
                               .astype(np.float32)).cuda().to(dtype)
        for kind in ("affine", "random", "edge"):
            sy, sx = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                      for a in xy_shifts(rng, kind, TRAIN_B, wr, wr, 640,
                                         margin))
            err = max(err, check_shear_xy(f"{kind} shifts", img, sy, sx,
                                          640, 3))
        del img
        for px in (1, 3):
            x, r, s = 301, 277, 200
            img = torch.from_numpy(rng.uniform(0, 255, (3, x, r * px))
                                   .astype(np.float32)).cuda().to(dtype)
            for kind in ("affine", "random", "edge"):
                sy, sx = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                          for a in xy_shifts(rng, kind, 3, x, r, s, 40))
                err = max(err, check_shear_xy(f"{kind} shifts", img, sy, sx,
                                              s, px))
        for name, rows, base in (("pass 2 (y-shear)", wr, margin),
                                 ("pass 3 (x-shear)", 640, margin)):
            img = torch.from_numpy(rng.uniform(0, 255, (TRAIN_B, rows,
                                                        wr * 3)).astype(
                np.float32)).cuda().to(dtype)
            shifts = torch.from_numpy(affine_shifts(rng, TRAIN_B, rows,
                                                    base)).cuda()
            err = max(err, check_shear(name, img, shifts, 640, 3))
        for px in (1, 3):
            w, out_w = 700, 512
            k_max = w - out_w - 2
            img = torch.from_numpy(rng.uniform(0, 255, (4, 256, w * px))
                                   .astype(np.float32)).cuda().to(dtype)
            free = rng.uniform(-2.0, k_max + 3.0, (4, 256)).astype(np.float32)
            err = max(err, check_shear(
                "random shifts", img, torch.from_numpy(free).cuda(), out_w,
                px))
            err = max(err, check_shear("edge shifts", img, torch.from_numpy(
                shear_edge_shifts(4, 256, k_max)).cuda(), out_w, px))
    return err


def augment_card_vs_cpu(tiles, hw, labels, draws, size):
    """augment_with_draws on the card against the CPU (plain versions) on
    one set of draws: the images before HSV (the draws' do_hsv off) within
    AUG_IMG_TOL, the card's HSV against the CPU's HSV of the card's
    pre-HSV images within AUG_HSV_TOL, labels within AUG_LABEL_TOL, the
    label rows' order and padding exact. Returns the differences; fails
    past a limit."""
    import torch

    from yolox_tpu_torch.data import augment_with_draws
    from yolox_tpu_torch.data.device_augment import hsv_jitter

    b = tiles.shape[0]
    no_hsv = dict(draws, do_hsv=torch.zeros(b, dtype=torch.bool))
    cpu = [torch.as_tensor(a) for a in (tiles, hw, labels)]
    card = [a.cuda() for a in cpu]
    out = {}
    for name, d, kw in (("pre_hsv", no_hsv, dict(hsv_prob=0.5)),
                        ("full", draws, {})):
        out[name] = [augment_with_draws(*args, d, (size, size), **kw)
                     for args in (cpu, card)]
    (pre_c, _), (pre_g, _) = out["pre_hsv"]
    (img_c, lab_c), (img_g, lab_g) = out["full"]
    pre_g, img_g, lab_g = pre_g.cpu(), img_g.cpu(), lab_g.cpu()
    hsv_ref = hsv_jitter(pre_g, draws["hsv_gains"].cpu())
    r = {"pre_hsv_max_abs": float((pre_g - pre_c).abs().max()),
         "pre_hsv_mean_abs": float((pre_g - pre_c).abs().mean()),
         "hsv_max_abs": float((img_g - hsv_ref).abs().max()),
         "label_max_abs": float((lab_g - lab_c).abs().max()),
         "full_max_abs": float((img_g - img_c).abs().max()),
         "full_mean_abs": float((img_g - img_c).abs().mean()),
         "label_rows": int((lab_c != 0).any(-1).sum())}
    rows = torch.equal((lab_g != 0).any(-1), (lab_c != 0).any(-1))
    log(f"augmentation B {b} {size} px, card vs CPU on the same draws: "
        f"{json.dumps(r)}, rows exact {rows} (limits: pre-HSV "
        f"{AUG_IMG_TOL}, HSV {AUG_HSV_TOL}, labels {AUG_LABEL_TOL})")
    if not (r["pre_hsv_max_abs"] <= AUG_IMG_TOL
            and r["hsv_max_abs"] <= AUG_HSV_TOL
            and r["label_max_abs"] <= AUG_LABEL_TOL and rows
            and r["label_rows"] > 0 and bool(torch.isfinite(img_g).all())):
        raise AssertionError("the card's augmentation disagrees with the "
                             "CPU's")
    return r


def phase_augment_parity(rng):
    """device_augment_batch's draws, taken once on a CPU generator, applied
    on the card and on the CPU at B 2, 640 px, default settings
    (`augment_card_vs_cpu`)."""
    import torch

    from yolox_tpu_torch.data import sample_augment_draws

    tiles, hw, labels = synthetic_tiles(rng, 2)
    draws = sample_augment_draws(2, torch.Generator().manual_seed(11),
                                 (640, 640))
    return augment_card_vs_cpu(tiles, hw, labels, draws, 640)


def phase_train_aug(cfg, tiles, hw, labels, n_kernel_convs):
    """The augmented main path: make_augmented_train_step on yolox-s,
    640 px, B 16, fused_bwd, 3 steps in float32 and 3 in bf16 from a CUDA
    generator; the launch counters set to 0 just before each step and read
    just after. Returns the launches over the 6 steps."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import (
        init_train_state,
        make_augmented_train_step,
    )

    counters = _launch_counters()
    want = {"shear_xy": 1, "shear_x": 0, "reduce_sums": n_kernel_convs,
            "main_1x1": n_kernel_convs, "stem": 0, "nms": 0,
            "int8_conv": 0, "int8_dwconv": 0}
    total = dict.fromkeys(counters, 0)
    args = [torch.from_numpy(a).cuda() for a in (tiles, hw, labels)]
    for dtype in (torch.float32, torch.bfloat16):
        module = YoloxModule.from_config(cfg, rng_seed=4321)
        state = init_train_state(module)
        step = make_augmented_train_step(module, cfg.num_classes,
                                         compute_dtype=dtype, fused_bwd=True)
        gen = torch.Generator(device=args[0].device).manual_seed(5)
        for i in range(3):
            torch.cuda.synchronize()
            for f in counters.values():
                f.launches = 0
            state, losses = step(state, *args, gen, 0.01, (640, 640))
            torch.cuda.synchronize()
            n = {k: f.launches for k, f in counters.items()}
            vals = {k: round(float(v), 5) for k, v in losses.items()}
            log(f"augmented step {i} {str(dtype).split('.')[-1]}: launches "
                f"{n} losses {vals}")
            if n != want:
                raise AssertionError(f"an augmented step launched {n}, want "
                                     f"{want}")
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError("an augmented step gave a non-finite "
                                     "loss")
            if vals["num_fg"] <= 0:
                raise AssertionError("an augmented step assigned no "
                                     "foreground")
            for k in total:
                total[k] += n[k]
        del module, state, step
        torch.cuda.empty_cache()
    return total


def phase_aug_times(cfg, tiles, hw, labels):
    """B 16, 640 px: augmentation ms per batch; the augmented step against
    the plain step on an augmented batch (`make_train_step`), fused_bwd, both
    dtypes, with the device's busy share and peak memory."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import (
        init_train_state,
        make_augmented_train_step,
        make_train_step,
    )
    from yolox_tpu_torch.data import device_augment_batch

    args = [torch.from_numpy(a).cuda() for a in (tiles, hw, labels)]
    gen = torch.Generator(device=args[0].device).manual_seed(6)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        torch.cuda.reset_peak_memory_stats()
        samples = _event_ms(lambda: device_augment_batch(
            *args, gen, (640, 640), image_dtype=dtype), 5)
        aug = {"median_ms": float(np.median(samples)), "samples_ms": samples,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        dev_ms, top = device_time(lambda: device_augment_batch(
            *args, gen, (640, 640), image_dtype=dtype))
        if top:
            aug["device_ms"] = dev_ms
            aug["device_busy"] = dev_ms / aug["median_ms"]
        out[f"augment_{name}"] = aug
        log(f"augmentation B {TRAIN_B} {name}: {aug}; device kernels (ms per "
            "batch): " + json.dumps([(k[:60], round(v, 3))
                                     for k, v in top[:8]]))
        imgs, packed = device_augment_batch(*args, gen, (640, 640),
                                            image_dtype=dtype)
        for kind in ("augmented", "plain"):
            module = YoloxModule.from_config(cfg, rng_seed=4321)
            state = init_train_state(module)
            if kind == "augmented":
                step = make_augmented_train_step(
                    module, cfg.num_classes, compute_dtype=dtype,
                    fused_bwd=True)

                def run():
                    return step(state, *args, gen, 0.01, (640, 640))
            else:
                step = make_train_step(module, cfg.num_classes,
                                       compute_dtype=dtype, fused_bwd=True)

                def run():
                    return step(state, imgs, packed, 0.01)
            torch.cuda.reset_peak_memory_stats()
            samples = _event_ms(run, 5)
            med = float(np.median(samples))
            r = {"median_ms": med, "img_per_s": 1e3 * TRAIN_B / med,
                 "samples_ms": samples,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            dev_ms, top = device_time(run)
            if top:
                r["device_ms"] = dev_ms
                r["device_busy"] = dev_ms / med
            out[f"{kind}_step_{name}"] = r
            log(f"{kind} step {name} fused B {TRAIN_B}: {r}; device kernels "
                "(ms per step): " + json.dumps([(k[:60], round(v, 3))
                                                for k, v in top[:8]]))
            del module, state, step
            torch.cuda.empty_cache()
    return out


def shear_times(rng):
    """K5 at the 640 px warp's shapes, B 16, bf16 (the card's buffer
    dtype on the main path) and float32. The fused kernel (`shear_xy`,
    h1t (16, WR, WR*3) -> (16, 640, 640*3), affine shifts as the warp
    gives them): ms per launch from CUDA events, device ms alone
    (`queued_ms`), plain ms, `shear_xy_bound`, and the F.grid_sample
    yardstick (two calls, one per pass, each the same two-tap row lerp on
    a planar (B, 3, H, W) copy, align_corners=True; timed only). Beside
    it the two-launch path it replaced, on the same inputs: the
    single-pass kernel (`shear_x`) on each pass and the transpose between
    them, by both clocks, with the two passes' bounds."""
    import torch
    import torch.nn.functional as F

    from yolox_tpu_torch.ops.shear_kernel import (
        shear_x,
        shear_x_plain,
        shear_xy,
        shear_xy_plain,
    )

    margin, wr = warp_grid()

    def yardstick(img, shifts, dtype):
        b, rows = shifts.shape
        planar = img.reshape(b, rows, -1, 3).permute(0, 3, 1, 2).contiguous()
        w = planar.shape[3]
        gx = (torch.arange(640, device=img.device)[None, None]
              + shifts[..., None]) * (2.0 / (w - 1)) - 1.0
        gy = (torch.arange(rows, device=img.device) * (2.0 / (rows - 1))
              - 1.0)[None, :, None].expand_as(gx)
        grid = torch.stack([gx, gy], -1).to(dtype)
        return lambda: F.grid_sample(planar, grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        h1t = torch.from_numpy(rng.uniform(0, 255, (TRAIN_B, wr, wr * 3))
                               .astype(np.float32)).cuda().to(dtype)
        sy_np, sx_np = xy_shifts(rng, "affine", TRAIN_B, wr, wr, 640, margin)
        sy, sx = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                  for a in (sy_np, sx_np))
        h2 = shear_x(h1t, sy, 640, 3)
        h2t = h2.reshape(TRAIN_B, wr, 640, 3).transpose(1, 2).reshape(
            TRAIN_B, 640, wr * 3)
        lib2, lib3 = yardstick(h1t, sy, dtype), yardstick(h2t, sx, dtype)

        def fused():
            return shear_xy(h1t, sy, sx, 640, 3)

        def library():
            return lib2(), lib3()

        t = {"ms": cuda_ms(fused, 20), "device_ms": queued_ms(fused, 20),
             "plain_ms": cuda_ms(lambda: shear_xy_plain(h1t, sy, sx, 640, 3),
                                 5),
             "library_ms": cuda_ms(library, 10),
             "library_device_ms": queued_ms(library, 10)}
        t["bound_ms"], t["bound_by"] = shear_xy_bound(
            sy_np, sx_np, wr, 640, 3, h1t.element_size())
        steps = {
            "pass2": (lambda: shear_x(h1t, sy, 640, 3),
                      lambda: shear_x_plain(h1t, sy, 640, 3), lib2, wr),
            "transpose": (lambda: h2.reshape(TRAIN_B, wr, 640, 3).transpose(
                1, 2).contiguous(), None, None, None),
            "pass3": (lambda: shear_x(h2t, sx, 640, 3),
                      lambda: shear_x_plain(h2t, sx, 640, 3), lib3, 640)}
        two = {}
        for key, (kern, plain, lib, rows) in steps.items():
            r = {"ms": cuda_ms(kern, 20), "device_ms": queued_ms(kern, 20)}
            if plain is not None:
                r["plain_ms"] = cuda_ms(plain, 5)
                r["library_ms"] = cuda_ms(lib, 10)
                r["library_device_ms"] = queued_ms(lib, 10)
                r["bound_ms"], r["bound_by"] = shear_bound(
                    TRAIN_B * rows, 640 * 3, 3, h1t.element_size())
            two[key] = r
        two["per_step"] = {q: sum(two[k][q] for k in steps)
                           for q in ("ms", "device_ms")}
        two["per_step"]["bound_ms"] = (two["pass2"]["bound_ms"]
                                       + two["pass3"]["bound_ms"])
        out[name] = {**t, "two_launch_path": two}
        log(f"K5 {name} fused (B {TRAIN_B}, {tuple(h1t.shape)} -> "
            f"{(TRAIN_B, 640, 640 * 3)}): {t}")
        log(f"K5 {name} two-launch path on the same inputs: {two}")
        del h1t, h2, h2t, lib2, lib3
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ evaluation phase

CARD = "cuda"       # the evaluation phase's device
EVAL_N = 64         # synthetic evaluation images, longer side 640
EVAL_B = 32         # evaluation batch
EVAL_WINDOW = 5     # the timed evaluation: the set 5 times, 320 images
# image shapes (h, w) the set cycles through: longer side 640, so the
# letterbox ratio is 1 and no resize (no cv2, no Pillow) is needed
EVAL_SHAPES = ((640, 640), (480, 640), (640, 480), (512, 640), (640, 427),
               (360, 640))
# card against CPU, float32 with TF32 off: each image's detections at
# `assert_dets_match`'s rtol 1e-4 / atol 1e-2, at a score threshold in a
# gap of the CPU's scores; the 12 COCO statistics within EVAL_F32_STAT_TOL
# (the set's ground truth is the CPU run's own detections, so both score
# ~1, and boxes that agree to 1e-4 relative match them the same way)
EVAL_F32_STAT_TOL = 1e-3
# bf16 (a bf16 module, half=True): each layer rounds to bf16, and cuDNN
# and the CPU round at other points, so scores part by ~1% (10% at worst)
# and boxes by ~1 px. Held: at least EVAL_BF16_MATCH of the CPU bf16
# run's detections have a card detection of the same class with IoU >=
# 0.9 and score within 10% relative; detection counts within 5%; the
# statistics within EVAL_BF16_STAT_TOL
EVAL_BF16_MATCH = 0.95
EVAL_BF16_STAT_TOL = 0.02
# the oracle: ~1000 jittered duplicates of each ground-truth box (IoU >
# 0.9 with it, lower scores, the same class) that K2 must suppress
ORACLE_DUPS = 1000


def eval_images(n=EVAL_N, seed=5):
    """n seeded BGR uint8 images of `EVAL_SHAPES`."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, EVAL_SHAPES[i % len(EVAL_SHAPES)] + (3,),
                         dtype=np.uint8) for i in range(n)]


def coco_json(path, images, boxes):
    """A COCO annotation file for `images` (ids 0..n-1) and per-image
    (m, 5) rows (x1, y1, x2, y2, class index) over the 80 COCO classes
    (category id = class index + 1)."""
    from yolox_tpu_torch.data import COCO_CLASSES

    anns, k = [], 0
    for i, rows in enumerate(boxes):
        for x1, y1, x2, y2, c in rows:
            k += 1
            anns.append({"id": k, "image_id": i, "category_id": int(c) + 1,
                         "bbox": [float(x1), float(y1), float(x2 - x1),
                                  float(y2 - y1)],
                         "area": float((x2 - x1) * (y2 - y1)),
                         "iscrowd": 0})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps({
        "images": [{"id": i, "height": int(im.shape[0]),
                    "width": int(im.shape[1]), "file_name": f"{i:012}.jpg"}
                   for i, im in enumerate(images)],
        "annotations": anns,
        "categories": [{"id": c + 1, "name": name}
                       for c, name in enumerate(COCO_CLASSES)]}))


def eval_config(cfg, root, images, conf):
    """A copy of `cfg` whose evaluation set is `images`, held in memory
    (`root/annotations/instances_val2017.json` holds their annotations),
    with `test_conf` = conf."""
    from yolox_tpu_torch.data import CocoDataset, ValTransform

    class InMemoryCoco(CocoDataset):
        def load_image(self, index):
            return images[self.ids[index]]

    class EvalConfig(type(cfg)):
        def get_eval_dataset(self, **kwargs):
            return InMemoryCoco(data_dir=root,
                                json_file="instances_val2017.json",
                                name="val2017", img_size=self.test_size,
                                preproc=ValTransform())

    out = EvalConfig()
    out.__dict__.update(cfg.__dict__)
    out.data_dir, out.test_conf, out.data_num_workers = root, conf, 0
    return out


def run_evaluation(ecfg, module, half=False, outputs=True):
    """`get_evaluator` + `eval`: (stats, {image id: (n, 7) rows (box,
    score, 1, category)} when `outputs`, the evaluator, wall seconds)."""
    import torch

    evaluator = ecfg.get_evaluator(EVAL_B)
    t0 = time.perf_counter()
    res = ecfg.eval(module, evaluator, half=half, return_outputs=outputs)
    if module.device.type != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not outputs:
        return evaluator.stats, None, evaluator, wall
    out = res[1]
    rows = {}
    for img_id, o in out.items():
        n = len(o["scores"])
        rows[img_id] = np.concatenate(
            [np.asarray(o["bboxes"], np.float64).reshape(n, 4),
             np.asarray(o["scores"], np.float64)[:, None], np.ones((n, 1)),
             np.asarray(o["categories"], np.float64)[:, None]], 1)
    return evaluator.stats, rows, evaluator, wall


def _box_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:4] - x[:, :2], -1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def bf16_match_fraction(got, want):
    """Share of `want`'s detection rows (all images) that a `got` row of
    the same category matches at IoU >= 0.9 and score within 10%."""
    hit = total = 0
    for img_id, w in want.items():
        total += len(w)
        g = got.get(img_id, np.zeros((0, 7)))
        if not len(w) or not len(g):
            continue
        iou = _box_iou(w[:, :4], g[:, :4])
        same = (w[:, None, 6] == g[None, :, 6]) & (np.abs(
            w[:, None, 4] - g[None, :, 4]) <= 0.1 * w[:, None, 4])
        hit += int(((iou >= 0.9) & same).any(1).sum())
    return hit / max(total, 1)


def phase_nms_any_k(rng):
    """K2 bit-equal to its plain version past the old 1024 limit: K 1024,
    1025, 2048, 4096 and 8400 with scattered and prefix valid masks at
    thr 0.3 and 0.65 (B so that the plain version's (B, K, K) float32 IoU
    stays under ~0.6 GB), each G (row tiles a block), the ring forced to
    1 and 8 rows, and the edge cases at thr 0 and 1."""
    import torch

    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    def check(name, boxes, valid, thr, rows=None, group=None):
        got = nms_keep(boxes, valid, thr, rows, group)
        if not torch.equal(got, nms_keep_plain(boxes, valid, thr)):
            raise AssertionError(f"K2 disagrees with its plain version: "
                                 f"{name} thr {thr}")
        return int(got.sum())

    kept = {}
    for k, b in ((1024, 32), (1025, 16), (2048, 8), (4096, 4), (8400, 2)):
        boxes = torch.from_numpy(random_boxes(rng, b, k, 50.0, 400.0)).cuda()
        scattered = torch.from_numpy(rng.random((b, k)) > 0.2).cuda()
        prefix = torch.arange(k, device=boxes.device)[None] < \
            torch.from_numpy(rng.integers(k // 2, k + 1, (b, 1))).cuda()
        for vname, valid in (("scattered", scattered), ("prefix", prefix)):
            for thr in (0.3, 0.65):
                kept[f"k{k} b{b} {vname} {thr}"] = check(
                    f"K {k} B {b} {vname}", boxes, valid, thr)
        if k in (1025, 8400):
            for rows, group in ((1, 4), (8, 2)):
                check(f"K {k} ring rows {rows} G {group}", boxes, scattered,
                      0.5, rows, group)
        for group in (1, 2, 4):
            check(f"K {k} G {group}", boxes, prefix, 0.65, None, group)
    eb, ev = (torch.from_numpy(a).cuda() for a in nms_edge_cases())
    for thr in (0.0, 1.0):
        check("edge cases", eb, ev, thr)
    log("K2 bit-equal to its plain version at K 1024-8400 (scattered and "
        "prefix valid, thr 0.3 / 0.65, G 1 / 2 / 4, forced ring sizes, edge "
        "cases); "
        "kept: " + json.dumps(kept))


def oracle_boxes(rng, images):
    """Per image 1-4 ground-truth boxes of random classes in distinct cells
    of a 3 x 3 grid over the image (no two overlap)."""
    out = []
    for im in images:
        h, w = im.shape[:2]
        cells = rng.permutation(9)[:int(rng.integers(1, 5))]
        rows = []
        for c in cells:
            cy, cx = divmod(int(c), 3)
            bw, bh = rng.uniform(0.3, 0.9) * w / 3, rng.uniform(0.3, 0.9) * h / 3
            x1 = cx * w / 3 + rng.uniform(0, w / 3 - bw)
            y1 = cy * h / 3 + rng.uniform(0, h / 3 - bh)
            rows.append((x1, y1, x1 + bw, y1 + bh, int(rng.integers(0, 80))))
        out.append(np.asarray(rows))
    return out


class OracleModel:
    """Decoded predictions (B, A, 85) for the batch's images: each ground
    truth box at 0.99, then `ORACLE_DUPS` copies of it with every side
    moved by up to 2% of the box's size (IoU > 0.9) at scores in (0.2,
    0.9), the rest of the A rows empty. `ids` is set by `IdsLoader`."""

    def __init__(self, dataset, device, anchors):
        self.dataset, self.device, self.anchors = dataset, device, anchors
        self.ids = []

    def __call__(self, x):
        import torch

        out = np.zeros((x.shape[0], self.anchors, 85), np.float32)
        out[..., 2:4] = 1.0
        for i, idx in enumerate(self.ids):
            rng = np.random.default_rng(1000 + idx)
            labels = self.dataset.load_anno(idx)
            n = len(labels)
            for k, (x1, y1, x2, y2, c) in enumerate(labels):
                size = np.array([x2 - x1, y2 - y1] * 2)
                dup = np.array([x1, y1, x2, y2]) + rng.uniform(
                    -0.02, 0.02, (ORACLE_DUPS, 4)) * size
                sl = slice(n + k * ORACLE_DUPS, n + (k + 1) * ORACLE_DUPS)
                out[i, sl, 0:2] = (dup[:, :2] + dup[:, 2:]) / 2
                out[i, sl, 2:4] = dup[:, 2:] - dup[:, :2]
                out[i, sl, 4] = rng.uniform(0.2, 0.9, ORACLE_DUPS)
                out[i, sl, 5 + int(c)] = 1.0
                out[i, k, :4] = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                 y2 - y1]
                out[i, k, 4] = out[i, k, 5 + int(c)] = 0.99
        return torch.from_numpy(out).to(self.device)


class IdsLoader:
    """A loader that tells a model (`.ids`) which images each batch holds:
    the oracle here, the tests' ground-truth models."""

    def __init__(self, loader, model):
        self.loader, self.model = loader, model
        self.dataset, self.batch_sampler = loader.dataset, loader.batch_sampler

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for imgs, targets, infos, ids in self.loader:
            self.model.ids = [int(np.asarray(i).reshape(-1)[0]) for i in ids]
            yield imgs, targets, infos, ids


def phase_oracle(cfg, rng, root):
    """The oracle evaluation on the card and on the CPU at max_det 1024
    and 2048: AP50 > 0.99, every statistic and every image's detections
    equal to the CPU's, and exactly the ground-truth boxes kept."""
    import torch

    from yolox_tpu_torch.evaluators import CocoEvaluator
    from yolox_tpu_torch.ops.nms_kernel import nms_keep

    images = eval_images()
    gt = oracle_boxes(rng, images)
    coco_json(Path(root) / "annotations" / "instances_val2017.json",
              images, gt)
    ecfg = eval_config(cfg, root, images, cfg.test_conf)
    anchors = 4 * ORACLE_DUPS + 8
    out = {}
    for max_det in (1024, 2048):
        res = {}
        for dev in (CARD, "cpu"):
            loader = ecfg.get_eval_loader(EVAL_B)
            model = OracleModel(loader.dataset, torch.device(dev), anchors)
            ev = CocoEvaluator(IdsLoader(loader, model), ecfg.test_size,
                               ecfg.test_conf, ecfg.nmsthre, 80,
                               max_det=max_det)
            nms_keep.launches = 0
            (ap, ap50, _), dets = ev.evaluate(model, return_outputs=True)
            res[dev] = (ev.stats, dets, nms_keep.launches)
        (stats, dets, launches), (cstats, cdets, _) = res[CARD], res["cpu"]
        if launches != -(-EVAL_N // EVAL_B):
            raise AssertionError(f"the oracle run launched K2 {launches} "
                                 "times")
        if not stats[1] > 0.99 or not np.array_equal(stats, cstats):
            raise AssertionError(f"oracle at max_det {max_det}: card stats "
                                 f"{stats.tolist()}, CPU {cstats.tolist()}")
        for img_id, g in enumerate(gt):
            d, c = dets[img_id], cdets[img_id]
            if d != c or len(d["scores"]) != len(g) \
                    or min(d["scores"]) < 0.98:
                raise AssertionError(f"oracle image {img_id}: kept "
                                     f"{len(d['scores'])} of {len(g)} boxes")
        out[f"max_det_{max_det}"] = {"AP50": float(stats[1]),
                                     "AP": float(stats[0])}
        log(f"oracle evaluation at max_det {max_det}: {EVAL_N} images, "
            f"{sum(len(g) for g in gt)} boxes under {ORACLE_DUPS} duplicates"
            f" each, card = CPU, stats {np.round(stats, 4).tolist()}")
    return out


def phase_eval_model(cfg, root):
    """yolox-s at 640 px, full width and depth, through `get_evaluator` /
    `eval` on the card in float32 and bf16 against the CPU, on 64 images
    whose ground truth is the CPU float32 run's own detections; launch
    counts read around each card run. Returns (results, the card's
    float32 and bf16 modules, the evaluation config, the set's images and
    ground truth)."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.ops.nms import postprocess_device
    from yolox_tpu_torch.ops.nms_kernel import nms_keep
    from yolox_tpu_torch.ops.preproc import preproc
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=4321, device="cpu"),
        np.random.default_rng(7).integers(0, 256, (2, 640, 640, 3),
                                          dtype=np.uint8))
    images = eval_images()
    x = np.stack([preproc(im, cfg.test_size)[0] for im in images])
    outs = [cpu_mod(x[i:i + EVAL_B]) for i in range(0, EVAL_N, EVAL_B)]
    scores = torch.cat([o[..., 4] * o[..., 5:].amax(-1) for o in outs]).numpy()
    # a gap between the top 1% and 0.1% of the scores (yolox-s: ~10
    # candidates an image above it); the devices' scores agree to ~1e-5
    # relative, so a gap of 2e-4 keeps the same candidates on both
    conf, gap = gap_threshold(scores, float(np.quantile(scores, 0.99)),
                              float(np.quantile(scores, 0.999)))
    if gap < 2e-4:
        raise AssertionError("no score gap wide enough to compare devices")
    gt = []
    for out in outs:
        dets, valid = postprocess_device(out, 80, conf, cfg.nmsthre, False,
                                         1024)
        gt += [d[v][:, [0, 1, 2, 3, 6]].numpy().astype(np.float64)
               for d, v in zip(dets, valid)]
    gt = [np.clip(g, 0, None) for g in gt]
    coco_json(Path(root) / "annotations" / "instances_val2017.json",
              images, gt)
    ecfg = eval_config(cfg, root, images, conf)
    log(f"evaluation set: {EVAL_N} images, {sum(len(g) for g in gt)} boxes "
        f"(the CPU's detections at conf {conf:.5f}, gap {gap:.2g})")

    gpu_mod = YoloxModule.from_config(cfg, rng_seed=4321, device=CARD)
    gpu_mod.load_params(cpu_mod.state_dict())
    cstats, crows, cev, _ = run_evaluation(ecfg, cpu_mod)
    torch.cuda.synchronize()
    stem_conv_bn_act.launches = nms_keep.launches = 0
    stats, rows, ev, _ = run_evaluation(ecfg, gpu_mod)
    launches = {"stem": stem_conv_bn_act.launches, "nms": nms_keep.launches}
    batches = -(-EVAL_N // EVAL_B)
    log(f"evaluation main path: {batches} batches, launches {launches}, "
        f"COCO matching {ev.matcher} (CPU run: {cev.matcher})")
    if launches != {"stem": batches, "nms": batches}:
        raise AssertionError("evaluation did not run through K1 and K2 "
                             "once per batch")
    if set(rows) != set(crows):
        raise AssertionError("the card and the CPU found detections in "
                             "different images")
    for img_id, want in crows.items():
        got = rows[img_id]
        if got.shape != want.shape:
            raise AssertionError(f"image {img_id}: {len(got)} detections on "
                                 f"the card, {len(want)} on the CPU")
        n = len(want)
        assert_dets_match(got[None], np.ones((1, n), bool), want[None],
                          np.ones((1, n), bool))
    if not np.allclose(stats, cstats, rtol=0, atol=EVAL_F32_STAT_TOL):
        raise AssertionError(f"float32 stats {stats.tolist()} against the "
                             f"CPU's {cstats.tolist()}")
    log(f"float32 evaluation matches the CPU: {sum(map(len, rows.values()))}"
        f" detections, stats {np.round(stats, 4).tolist()}")

    bf_gpu = YoloxModule.from_config(cfg, rng_seed=4321, device=CARD,
                                     dtype=torch.bfloat16)
    bf_gpu.load_params(cpu_mod.state_dict())
    bf_cpu = YoloxModule.from_config(cfg, rng_seed=4321, device="cpu",
                                     dtype=torch.bfloat16)
    bf_cpu.load_params(cpu_mod.state_dict())
    torch.cuda.synchronize()
    stem_conv_bn_act.launches = nms_keep.launches = 0
    bstats, brows, _, _ = run_evaluation(ecfg, bf_gpu, half=True)
    launches_bf16 = {"stem": stem_conv_bn_act.launches,
                     "nms": nms_keep.launches}
    log(f"bf16 evaluation: launches {launches_bf16}")
    if launches_bf16 != {"stem": batches, "nms": batches}:
        raise AssertionError("bf16 evaluation did not run through K1 and "
                             "K2 once per batch")
    bcstats, bcrows, _, _ = run_evaluation(ecfg, bf_cpu, half=True)
    frac = bf16_match_fraction(brows, bcrows)
    n_card = sum(map(len, brows.values()))
    n_cpu = sum(map(len, bcrows.values()))
    log(f"bf16 evaluation: {frac:.4f} of the CPU's {n_cpu} detections "
        f"matched by the card's {n_card}; stats card "
        f"{np.round(bstats, 4).tolist()}, CPU {np.round(bcstats, 4).tolist()}")
    if frac < EVAL_BF16_MATCH or abs(n_card - n_cpu) > 0.05 * n_cpu \
            or not np.allclose(bstats, bcstats, rtol=0,
                               atol=EVAL_BF16_STAT_TOL):
        raise AssertionError("bf16 evaluation on the card disagrees with "
                             "the CPU's beyond the stated tolerances")
    del bf_cpu, cpu_mod
    return ({"launches": launches, "launches_bf16": launches_bf16,
             "matcher": ev.matcher,
             "f32_stats": stats.tolist(), "bf16_stats": bstats.tolist(),
             "bf16_match": frac}, gpu_mod, bf_gpu, ecfg, images, gt)


def eval_breakdown(module, ecfg, half):
    """Device ms of one batch of 32 by stage: the forward, top-k and
    gather (the postprocess without K2) and K2 from torch.profiler; the
    host batch's copy to the card and the detections' copy back by CUDA
    events."""
    import torch

    from yolox_tpu_torch.evaluators.coco_evaluator import device_inference
    from yolox_tpu_torch.ops.nms import postprocess_device

    imgs = next(iter(ecfg.get_eval_loader(EVAL_B)))[0]
    xin = torch.as_tensor(imgs).cuda()
    if half:
        xin = xin.to(torch.bfloat16)
    out = module(xin).float()
    dets, valid = device_inference(module, imgs, half, 80, ecfg.test_conf,
                                   ecfg.nmsthre, 1024)
    parts = {"forward": device_time(lambda: module(xin))[0]}
    post_ms, post = device_time(lambda: postprocess_device(
        out, 80, ecfg.test_conf, ecfg.nmsthre, False, 1024))
    k2 = sum(t for k, t in post if "nms_kernel" in k)
    parts["topk_gather"] = post_ms - k2
    parts["k2"] = k2
    # the copies by CUDA events (the profiler gave a lone copy no device
    # time); pageable, so each ends on the host
    parts["copy_in_events"] = cuda_ms(lambda: torch.as_tensor(imgs).cuda(),
                                      3, warmup=1)
    parts["copy_out_events"] = cuda_ms(lambda: (dets.cpu(), valid.cpu()), 10)
    return parts


def eval_times(gpu_mod, bf_gpu, ecfg, images, gt, root):
    """Evaluation at `test_conf` 0.01 (the config's) and batch 32, float32
    and bf16: images/s = images over the wall time of one `eval` of the
    set repeated `EVAL_WINDOW` times (host letterbox, conversion and
    COCOeval included; the second of two runs), device ms a batch
    (`device_time` of `device_inference`) and its breakdown by stage."""
    from yolox_tpu_torch.evaluators.coco_evaluator import device_inference

    coco_json(Path(root) / "annotations" / "instances_val2017.json",
              images * EVAL_WINDOW, gt * EVAL_WINDOW)
    ecfg = eval_config(ecfg, root, images * EVAL_WINDOW, 0.01)
    n_window = EVAL_N * EVAL_WINDOW
    out = {}
    for name, mod, half in (("float32", gpu_mod, False),
                            ("bfloat16", bf_gpu, True)):
        for _ in range(2):
            _, _, ev, wall = run_evaluation(ecfg, mod, half, outputs=False)
        imgs = next(iter(ecfg.get_eval_loader(EVAL_B)))[0]

        def batch():
            dets, valid = device_inference(mod, imgs, half, 80, 0.01,
                                           ecfg.nmsthre, 1024)
            dets.cpu(), valid.cpu()

        dev_ms, top = device_time(batch)
        out[name] = {"img_per_s": n_window / wall, "wall_s": wall,
                     "images": n_window,
                     "device_ms_per_batch": dev_ms,
                     "stats": ev.stats.tolist(),
                     "breakdown_ms": eval_breakdown(mod, ecfg, half),
                     "top_kernels": [(k[:60], round(v, 4))
                                     for k, v in top[:6]]}
        log(f"evaluation {name} B {EVAL_B} at conf 0.01: {out[name]}")
    return out


def run_eval(cfg, rng, lines):
    """Phase 9: evaluation on the card."""
    import tempfile

    phase_nms_any_k(rng)
    with tempfile.TemporaryDirectory() as root:
        oracle = phase_oracle(cfg, rng, str(Path(root) / "oracle"))
        res, gpu_mod, bf_gpu, ecfg, images, gt = phase_eval_model(
            cfg, str(Path(root) / "model"))
        times = eval_times(gpu_mod, bf_gpu, ecfg, images, gt,
                           str(Path(root) / "window"))
    lines.append({"eval": {**res, "oracle": oracle, "times": times}})
    return res["launches"], res["launches_bf16"]


def run_serve(cfg, rng, lines):
    """Phases 2-5; returns the kernels-line entries of K1 and K2."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.models.blocks import fold_focus_weight

    stem_mod = YoloxModule.from_config(cfg, rng_seed=4321)
    focus = stem_mod.backbone.backbone.stem
    wb = fold_focus_weight(focus.conv.conv.weight).contiguous()
    del stem_mod
    c = wb.shape[0]
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).cuda()
    stem_err = phase_stem(rng, wb, scale, bias)
    phase_nms(rng)
    launches, gpu_mod, threshold = phase_serve(cfg, rng)
    times = phase_times(rng, gpu_mod, wb, scale, bias, threshold)
    lines.append({"serve": times["serve"]})
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    # a case's inputs beside its times (K2's walk floor and per-box time
    # stay on its log line)
    case_keys = keys + ("B", "K", "valid", "walked")
    kernels = []
    for name, source, replaces, n, err, t, head, unit in (
            ("stem_conv_bn_act", "yolox_tpu_torch/csrc/stem.cu",
             "yolox_tpu/ops/pallas_stem.py:89", launches["stem"], stem_err,
             times["stem"], "b1", "one call at B 1, 640 px, uint8 in, "
             "float32 out"),
            ("nms_keep", "yolox_tpu_torch/csrc/nms.cu",
             "yolox_tpu/ops/pallas_nms.py:31", launches["nms"], 0.0,
             times["nms"], "serve_b1", "one call at B 1, 640 px, "
             "serving's candidates")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            **{k: t[head][k] for k in keys}, "unit": unit,
            **{case: {k: v for k, v in t[case].items() if k in case_keys}
               for case in t if case != head},
        })
    return kernels


def run_train(cfg, rng, shapes, multiscale, lines):
    """Phases 6-7; returns the kernels-line entries of K3 and K4."""
    conv_errs = phase_conv_bwd(shapes, multiscale)
    x_train = rng.uniform(0, 255, (TRAIN_B, 640, 640, 3)).astype(np.float32)
    labels = synthetic_labels(rng, TRAIN_B)
    train_launches = phase_train(cfg, x_train, labels, len(shapes))
    phase_train_parity(cfg, x_train, labels)
    lines.append({"train": phase_train_times(cfg, x_train, labels)})
    cb_times = conv_bwd_times(shapes)
    kernels = []
    for name, key, line, err in (
            ("reduce_sums", "k3", 123, conv_errs["k3"]),
            ("main_1x1", "k4", 162, conv_errs["k4"])):
        t = cb_times["float32"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "yolox_tpu_torch/csrc/conv_bwd.cu",
            "replaces": f"yolox_tpu/ops/pallas_conv_bwd.py:{line}",
            "launches": train_launches[name], "max_abs_err": err,
            **{q: t["per_step"][q] for q in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
            # the kernels' and the library's device time alone (profiler)
            "device_ms": t["per_step"]["device_ms"],
            "library_device_ms": t["per_step"]["library_device_ms"],
            "unit": f"sum over the {len(shapes)} launches of one B "
                    f"{TRAIN_B} float32 training step",
            "largest": t["largest"], "most_frequent": t["most_frequent"],
            "bf16": cb_times["bfloat16"][key],
        })
    return kernels


def run_augment(cfg, rng, n_kernel_convs, lines):
    """Phase 8; returns the kernels-line entry of K5."""
    shear_err = phase_shear(rng)
    aug_parity = phase_augment_parity(rng)
    tiles, tile_hw, tile_labels = synthetic_tiles(rng, TRAIN_B)
    aug_launches = phase_train_aug(cfg, tiles, tile_hw, tile_labels,
                                   n_kernel_convs)
    aug_times = phase_aug_times(cfg, tiles, tile_hw, tile_labels)
    k5_times = shear_times(rng)
    lines.append({"augment": {**aug_times, "card_vs_cpu": aug_parity,
                              "launches": aug_launches}})
    t = k5_times["bfloat16"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    return [{
        "name": "shear_xy", "route": "cuda",
        "source": "yolox_tpu_torch/csrc/warp.cu",
        "replaces": "yolox_tpu/ops/pallas_warp.py:196",
        "launches": aug_launches["shear_xy"], "max_abs_err": shear_err,
        **{q: t[q] for q in keys},
        "unit": f"one launch (passes 2 and 3 of the warp) of one B "
                f"{TRAIN_B} 640 px augmented step, bf16",
        "float32": {q: k5_times["float32"][q] for q in keys},
        # the single-pass kernel (shear_x, off the main path since the
        # fusion: 0 launches there) and the transpose it needed
        "two_launch_path": {"bfloat16": t["two_launch_path"],
                            "float32": k5_times["float32"][
                                "two_launch_path"]},
    }]


# ------------------------------------------------------- the trainer (10)

TRAINER_N = 96         # training images, in memory
TRAINER_EVAL_N = 32    # evaluation images, longer side 640
TRAINER_B = 16
TRAINER_CHECK_N = 8    # best_ckpt.pth: card against CPU on this many
# training image shapes (h, w): a longer side of 640 (no resize before
# the mosaic) and larger (pull_item and the MixUp partner resize)
TRAINER_SHAPES = ((640, 640), (480, 640), (720, 1280), (960, 720),
                  (640, 427), (1024, 768), (512, 640), (900, 1600))
# iterations of run (a) that torch.profiler traces (the trainer's own
# YOLOX_PROFILE_* hook): the busy share
TRAINER_PROFILE = (3, 3)
TRAINER_MULTISCALE_RANGE = 5   # sizes 480-800 px


def trainer_multiscale(cfg):
    """A copy of `cfg` with phase 10's multiscale range."""
    import copy

    out = copy.copy(cfg)
    out.multiscale_range, out.random_size = TRAINER_MULTISCALE_RANGE, None
    return out


def trainer_images(n, shapes, seed):
    """n seeded BGR uint8 images cycling through `shapes`, and per image
    1-10 boxes (x1, y1, x2, y2, class) inside it."""
    rng = np.random.default_rng(seed)
    images, boxes = [], []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        images.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        k = int(rng.integers(1, 11))
        bw = rng.uniform(16, w / 2, k)
        bh = rng.uniform(16, h / 2, k)
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        boxes.append(np.stack([x1, y1, x1 + bw, y1 + bh,
                               rng.integers(0, 80, k)], 1))
    return images, boxes


def anchor_start(module):
    """Starting weights that detect their own anchors: seeded yolox-s
    whose prediction biases say "class 0, box = the anchor cell" with the
    objectness of the stride-32 level highest (logit 3, the others -1;
    class 0 logit 2, the others -4; box offsets 0). At random init the
    eval features barely move the logits, so the ranked detections are
    the stride-32 anchor boxes; the weights stay as seeded, so training
    runs as it would from any init."""
    import torch

    head = module.head
    with torch.no_grad():
        for level, (obj, cls, reg) in enumerate(zip(
                head.obj_preds, head.cls_preds, head.reg_preds)):
            obj.bias.fill_(3.0 if level == len(head.obj_preds) - 1 else -1.0)
            cls.bias.fill_(-4.0)
            cls.bias[0] = 2.0
            reg.bias.zero_()
    return module


def anchor_boxes(images, size, stride=32):
    """Per image the (n, 5) rows (x1, y1, x2, y2, class 0) of the
    stride-`stride` anchor cells (`stride` squares centred on the grid
    points, as an untrained head decodes them) that lie inside the
    image's letterboxed area, in image coordinates."""
    from yolox_tpu_torch.ops.preproc import letterbox_ratio

    g = np.arange(1, size[0] // stride) * stride
    cy, cx = np.meshgrid(g, g, indexing="ij")
    cells = np.stack([cx - stride / 2, cy - stride / 2, cx + stride / 2,
                      cy + stride / 2, np.zeros_like(cx)], -1).reshape(-1, 5)
    out = []
    for im in images:
        r = letterbox_ratio(im.shape[:2], size)
        inside = (cells[:, 2] <= im.shape[1] * r) & \
            (cells[:, 3] <= im.shape[0] * r)
        rows = cells[inside].astype(np.float64)
        rows[:, :4] /= r
        out.append(rows)
    return out


def trainer_config(cfg, root, train, evaluation, **fields):
    """A copy of `cfg` whose training and evaluation sets are held in
    memory (`load_image` returns the arrays; their annotations are JSON
    files under `root`), with `fields` set."""
    from yolox_tpu_torch.data import CocoDataset, TrainTransform, ValTransform

    coco_json(Path(root) / "annotations" / "instances_train2017.json",
              *train)
    coco_json(Path(root) / "annotations" / "instances_val2017.json",
              *evaluation)

    def in_memory(images):
        class InMemoryCoco(CocoDataset):
            def load_image(self, index):
                return images[self.ids[index]]

        return InMemoryCoco

    train_set, eval_set = in_memory(train[0]), in_memory(evaluation[0])

    class TrainerConfig(type(cfg)):
        def get_dataset(self, cache=False, cache_type="ram"):
            return train_set(data_dir=root,
                             json_file="instances_train2017.json",
                             name="train2017", img_size=self.input_size,
                             preproc=TrainTransform(
                                 max_labels=50, flip_prob=self.flip_prob,
                                 hsv_prob=self.hsv_prob))

        def get_eval_dataset(self, **kwargs):
            return eval_set(data_dir=root, json_file="instances_val2017.json",
                            name="val2017", img_size=self.test_size,
                            preproc=ValTransform())

    out = TrainerConfig()
    out.__dict__.update(cfg.__dict__)
    out.data_dir, out.output_dir = root, str(Path(root) / "out")
    out.dataset = None
    for k, v in fields.items():
        setattr(out, k, v)
    return out


def _card_sync():
    import torch

    if CARD != "cpu":
        torch.cuda.synchronize()


def instrument_trainer(trainer, counters):
    """Wrap one trainer's hooks: per iteration its wall ms, loader wait,
    lr and losses, the launch counters set to 0 just before it and read
    just after; per evaluation the same counters; per epoch the wall time
    of its iterations."""
    rec = {"iters": [], "evals": [], "epochs": []}
    one_iter, one_eval = trainer.train_one_iter, \
        trainer.evaluate_and_save_model
    in_iter, before = trainer.train_in_iter, trainer.before_train

    def reset():
        _card_sync()
        for f in counters.values():
            f.launches = 0

    def read():
        _card_sync()
        return {k: f.launches for k, f in counters.items()}

    def iteration():
        reset()
        t0 = time.perf_counter()
        one_iter()
        n = read()
        rec["iters"].append({
            "progress": trainer.progress_in_iter, "epoch": trainer.epoch,
            "ms": 1e3 * (time.perf_counter() - t0),
            "data_ms": 1e3 * trainer.meter["data_time"].latest,
            "lr": trainer.meter["lr"].latest,
            "loss": trainer.meter["total_loss"].latest,
            "size": tuple(trainer._current_size),
            "device_augment": trainer._device_augment,
            "use_l1": trainer.use_l1,
            "mosaic": trainer.train_loader.batch_sampler.mosaic,
            "launches": n})

    def evaluation():
        reset()
        one_eval()
        rec["evals"].append({"epoch": trainer.epoch, "launches": read(),
                             "best_ap": trainer.best_ap})

    def epoch():
        _card_sync()
        t0 = time.perf_counter()
        in_iter()
        _card_sync()
        rec["epochs"].append(time.perf_counter() - t0)

    def before_train():
        before()
        rec["start_epoch"] = trainer.start_epoch
        rec["ema_updates_at_start"] = trainer.train_state.ema.updates

    trainer.train_one_iter, trainer.evaluate_and_save_model = iteration, \
        evaluation
    trainer.train_in_iter, trainer.before_train = epoch, before_train
    return rec


def check_trainer_run(name, trainer, rec, n_convs, aug_epochs):
    """Finite losses, the LR schedule, and the launch counts of every
    iteration (K3 / K4 `n_convs` times, K5 once in a device-augmented
    epoch) and evaluation (K1 and K2 once a batch)."""
    import math

    sched = trainer.exp.get_lr_scheduler(
        trainer.exp.basic_lr_per_img * TRAINER_B, trainer.max_iter)
    for it in rec["iters"]:
        if not math.isfinite(it["loss"]):
            raise AssertionError(f"{name}: non-finite loss at {it}")
        if it["lr"] != sched.update_lr(it["progress"] + 1):
            raise AssertionError(f"{name}: lr {it['lr']} at iteration "
                                 f"{it['progress']} off the schedule")
        k5 = 1 if it["epoch"] in aug_epochs else 0
        want = {"reduce_sums": n_convs, "main_1x1": n_convs, "stem": 0,
                "nms": 0, "shear_x": 0, "shear_xy": k5, "int8_conv": 0,
                "int8_dwconv": 0}
        if it["launches"] != want:
            raise AssertionError(f"{name}: iteration {it['progress']} "
                                 f"launched {it['launches']}, want {want}")
    batches = -(-TRAINER_EVAL_N // TRAINER_B)
    for ev in rec["evals"]:
        want = {"reduce_sums": 0, "main_1x1": 0, "stem": batches,
                "nms": batches, "shear_x": 0, "shear_xy": 0, "int8_conv": 0,
                "int8_dwconv": 0}
        if ev["launches"] != want:
            raise AssertionError(f"{name}: evaluation launched "
                                 f"{ev['launches']}, want {want}")
    sizes = sorted({it["size"] for it in rec["iters"]})
    log(f"trainer {name}: {len(rec['iters'])} iterations, finite losses, "
        f"lr on the schedule, launches per iteration K3/K4 {n_convs}, K5 "
        f"in epochs {sorted(aug_epochs)}; {len(rec['evals'])} evaluations "
        f"with K1/K2 {batches} each; sizes {sizes}; best AP "
        f"{trainer.best_ap:.4f}")


def check_resume(trainer, rec, run_a):
    """The resume of run (a) from its first epoch's checkpoint: it starts
    at epoch 1 with one epoch of EMA updates and runs (a)'s second epoch,
    iteration for iteration at the same LR, with the mosaic closed, L1 on
    and no device augmentation, as (a) did. (The multiscale sizes and the
    sampler's stream start again from their seeds, as in the JAX
    trainer.)"""
    n = trainer.max_iter
    if (rec["start_epoch"], rec["ema_updates_at_start"]) != (1, n) or \
            len(rec["iters"]) != n:
        raise AssertionError(
            f"resume started at epoch {rec['start_epoch']} with "
            f"{rec['ema_updates_at_start']} EMA updates and ran "
            f"{len(rec['iters'])} iterations; want 1, {n}, {n}")
    keys = ("progress", "epoch", "lr", "use_l1", "mosaic", "device_augment")
    want = [{k: it[k] for k in keys} for it in run_a["iters"][n:]]
    got = [{k: it[k] for k in keys} for it in rec["iters"]]
    if got != want:
        raise AssertionError(f"the resumed epoch differs from run (a)'s "
                             f"second: {got} against {want}")
    log(f"trainer a_resume: epoch 1 from epoch_1_ckpt.pth, {n} iterations "
        f"at run (a)'s LR, mosaic closed and L1 on as in (a)")


def trainer_times(rec, n_images):
    """images/s over each epoch, median iteration and loader-wait ms (the
    first iteration of a run and the profiled ones left out)."""
    skip = set(range(TRAINER_PROFILE[0],
                     TRAINER_PROFILE[0] + TRAINER_PROFILE[1]))
    iters = [it for it in rec["iters"][1:] if it["progress"] not in skip]
    return {"img_per_s_by_epoch": [n_images / t for t in rec["epochs"]],
            "epoch_s": rec["epochs"],
            "median_iter_ms": float(np.median([it["ms"] for it in iters])),
            "median_loader_wait_ms": float(np.median(
                [it["data_ms"] for it in iters])),
            "mean_loader_wait_ms": float(np.mean(
                [it["data_ms"] for it in iters])),
            "iter_ms": [round(it["ms"], 2) for it in rec["iters"]],
            "loader_wait_ms": [round(it["data_ms"], 2)
                               for it in rec["iters"]]}


def profiled_busy(trainer, median_iter_ms):
    """Device ms an iteration from the trainer's torch.profiler window
    (CUDA kernels and copies, summed) over the median iteration wall ms."""
    import torch

    per = {}
    for e in trainer.profiler.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total
    dev_ms = sum(per.values()) / 1e3 / TRAINER_PROFILE[1]
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms_per_iter": dev_ms,
            "busy": dev_ms / median_iter_ms,
            "top_kernels_ms_per_iter": [
                (k[:60], round(v / 1e3 / TRAINER_PROFILE[1], 3))
                for k, v in top]}


def loader_rates(tcfg, batches=6):
    """The host Mosaic/MixUp loader alone, as run (a) builds it: images/s
    over `batches` batches after the first, through this host's route
    and through cv2_compat's numpy versions (cv2 hidden from the workers)."""
    out = {}
    for route in ("host", "numpy"):
        with hidden_cv2() if route == "numpy" else contextlib.nullcontext():
            loader = tcfg.get_data_loader(TRAINER_B)
            batch_iter = iter(loader)
            next(batch_iter)
            t0 = time.perf_counter()
            for _ in range(batches):
                next(batch_iter)
            out[route] = batches * TRAINER_B / (time.perf_counter() - t0)
            loader.close()
    log(f"host Mosaic/MixUp loader alone, {tcfg.data_num_workers} workers, "
        f"img/s: {out}")
    return out


def cv2_compat_vs_host(seed=0):
    """`data/cv2_compat.py`'s numpy versions against this host's cv2 on
    seeded uint8 images: the letterbox resizes of the serving frames and
    two Mosaic-sized ones, 4 Mosaic warps (`get_affine_matrix`'s draws,
    1280 px canvas to 640, in the route of this cv2's major version), and
    HSV both ways on a 640 px and an
    odd-width image. Returns per op the largest difference in levels and
    the share of values that differ, with cv2's version and CPU features;
    fails past one level or a share of 1e-3 (the bound the CPU tests hold
    the loader to)."""
    import cv2

    from yolox_tpu_torch.data import cv2_compat as cc
    from yolox_tpu_torch.data.data_augment import get_affine_matrix

    rng = np.random.default_rng(seed)
    major = int(cv2.__version__.split(".")[0])
    out = {"cv2": cv2.__version__,
           "cpu_features": cv2.getCPUFeaturesLine()}

    def image(h, w):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def diff(name, got, want):
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        prev = out.get(name, {"max": 0, "share": 0.0})
        out[name] = {"max": max(prev["max"], int(d.max())),
                     "share": max(prev["share"], float((d > 0).mean()))}

    for (h, w), size in (((720, 1280), (640, 360)), ((375, 500), (640, 480)),
                         ((1000, 1500), (640, 426)), ((427, 640), (512, 341))):
        img = image(h, w)
        diff("resize", cc.resize_linear_numpy(img, size),
             cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))
    for _ in range(4):
        img = image(1280, 1280)
        m, _ = get_affine_matrix(rng, (640, 640), degrees=10.0,
                                 translate=0.1, scales=(0.1, 2), shear=2.0)
        diff("warp", cc.warp_affine_numpy(img, m, (640, 640),
                                          cv2_major=major),
             cv2.warpAffine(img, m, dsize=(640, 640),
                            borderValue=(114, 114, 114)))
    for h, w in ((640, 640), (375, 500)):
        img = image(h, w)
        diff("bgr_to_hsv", cc.bgr_to_hsv_numpy(img),
             cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        diff("hsv_to_bgr", cc.hsv_to_bgr_numpy(img),
             cv2.cvtColor(img, cv2.COLOR_HSV2BGR))
    log("cv2_compat's numpy versions against this host's cv2: "
        + json.dumps(out))
    for op in ("resize", "warp", "bgr_to_hsv", "hsv_to_bgr"):
        if out[op]["max"] > 1 or out[op]["share"] > 1e-3:
            raise AssertionError(f"cv2_compat's {op} is off this host's cv2 "
                                 f"{out['cv2']} by {out[op]}")
    return out


def check_best_checkpoint(cfg, path, images):
    """`best_ckpt.pth` loads strict into fresh modules on the card and the
    CPU, whose float32 detections on `images` agree (`assert_dets_match`,
    threshold in a gap of the CPU's scores)."""
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.ops.preproc import preproc
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    model = load_checkpoint(path)["model"]
    mods = {}
    for dev in (CARD, "cpu"):
        mods[dev] = YoloxModule.from_config(cfg, rng_seed=1, device=dev)
        mods[dev].load_params(model)  # strict
    x = np.stack([preproc(im, cfg.test_size, dtype=np.uint8)[0]
                  for im in images])
    scores = anchor_scores(mods["cpu"], x)
    conf, gap = gap_threshold(scores, *np.quantile(scores, [0.9, 0.999]))
    if gap < 2e-4:
        raise AssertionError("no score gap wide enough to compare devices")
    out = {}
    for dev, mod in mods.items():
        dets, valid = mod.serve(x, conf_thre=conf, max_det=1024)
        out[dev] = (dets.cpu().numpy(), valid.cpu().numpy())
    assert_dets_match(*out[CARD], *out["cpu"])
    n = int(out["cpu"][1].sum())
    log(f"best_ckpt.pth loads strict; card float32 detections match the "
        f"CPU's on {len(images)} images ({n} detections, conf {conf:.5f})")
    return n


def run_trainer(cfg, n_convs, plain_step_device_ms, lines):
    """Phase 10: `YoloxConfig.get_trainer(args).train()` on yolox-s at full
    width and depth, 640 px, B 16, bf16 (`fp16`), `fused_conv_bwd`:
    (a) host Mosaic/MixUp for an epoch, then the no-aug epoch, and the
    same run resumed from its first epoch's checkpoint; (b)
    `device_augment` for an epoch, then the no-aug epoch. Returns the
    launch totals."""
    import os
    import tempfile
    from argparse import Namespace

    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.data import cv2_compat
    from yolox_tpu_torch.utils.checkpoint import save_checkpoint

    route = cv2_compat.route()
    workers = min(8, os.cpu_count() or 1)
    log(f"trainer: cv2_compat route {route}, {workers} loader workers, "
        f"{os.cpu_count()} CPUs")
    counters = _launch_counters()
    train = trainer_images(TRAINER_N, TRAINER_SHAPES, 31)
    eval_imgs = eval_images(TRAINER_EVAL_N, seed=37)
    # the starting weights detect their own anchor cells (class 0) and the
    # evaluation set's ground truth is those cells, so the briefly trained
    # EMA model scores an AP above 0 and best-AP tracking writes
    # best_ckpt.pth
    start = anchor_start(
        YoloxModule.from_config(cfg, rng_seed=4321, device="cpu"))
    gt = anchor_boxes(eval_imgs, cfg.test_size)

    out = {"card": nvidia_smi() if CARD != "cpu" else "cpu",
           "cv2_compat_route": route, "workers": workers,
           "cpu_count": os.cpu_count(),
           "plain_step_device_ms_bf16_fused": plain_step_device_ms,
           "batch": TRAINER_B, "train_images": TRAINER_N,
           "eval_images": TRAINER_EVAL_N}
    if route == "cv2":
        out["cv2_compat_vs_host"] = cv2_compat_vs_host()
    else:
        log("no cv2 on this host to hold cv2_compat's numpy versions to")
    totals = dict.fromkeys(counters, 0)
    fields = dict(max_epoch=2, no_aug_epochs=0, warmup_epochs=1,
                  eval_interval=1,
                  multiscale_range=TRAINER_MULTISCALE_RANGE,
                  data_num_workers=workers, fused_conv_bwd=True,
                  save_history_ckpt=False, print_interval=10, seed=0)
    with tempfile.TemporaryDirectory() as root:
        start_ckpt = str(Path(root) / "start")
        save_checkpoint({"model": start.state_dict()}, False, start_ckpt,
                        "start")
        start_ckpt = str(Path(start_ckpt) / "start_ckpt.pth")
        # (a) keeps its per-epoch checkpoints; the resume restarts the
        # same run from the one written after its first epoch
        first_epoch = str(Path(root) / "out" / "a" / "epoch_1_ckpt.pth")
        runs = (("a", {"save_history_ckpt": True}, start_ckpt, False),
                ("a_resume", {}, first_epoch, True),
                ("b", {"device_augment": True}, start_ckpt, False))
        for name, extra, ckpt, resume in runs:
            tcfg = trainer_config(cfg, root, train, (eval_imgs, gt),
                                  **{**fields, **extra})
            args = Namespace(batch_size=TRAINER_B, fp16=True, cache=None,
                             logger="tensorboard", ckpt=ckpt,
                             resume=resume, start_epoch=None,
                             name=name.split("_")[0], device=CARD)
            profile_env = name == "a" and CARD != "cpu"
            if profile_env:
                os.environ.update({
                    "YOLOX_PROFILE_DIR": str(Path(root) / "trace"),
                    "YOLOX_PROFILE_START": str(TRAINER_PROFILE[0]),
                    "YOLOX_PROFILE_ITERS": str(TRAINER_PROFILE[1])})
            try:
                trainer = tcfg.get_trainer(args)
                rec = instrument_trainer(trainer, counters)
                if CARD != "cpu":
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer.train()
                wall = time.perf_counter() - t0
            finally:
                for k in ("YOLOX_PROFILE_DIR", "YOLOX_PROFILE_START",
                          "YOLOX_PROFILE_ITERS"):
                    os.environ.pop(k, None)
            aug = {0} if name == "b" else set()
            check_trainer_run(name, trainer, rec, n_convs, aug)
            for r in rec["iters"] + rec["evals"]:
                for k in totals:
                    totals[k] += r["launches"][k]
            res = {**trainer_times(rec, trainer.max_iter * TRAINER_B),
                   "train_s": wall, "best_ap": trainer.best_ap,
                   "evals": [(e["epoch"], round(e["best_ap"], 5))
                             for e in rec["evals"]],
                   "sizes": [it["size"][0] for it in rec["iters"]]}
            if CARD != "cpu":
                res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if profile_env:
                res.update(profiled_busy(trainer, res["median_iter_ms"]))
            files = sorted(p.name for p in Path(trainer.file_name).glob(
                "*_ckpt.pth"))
            res["checkpoints"] = files
            if name == "a":
                for f in ("latest_ckpt.pth", "last_mosaic_epoch_ckpt.pth",
                          "best_ckpt.pth"):
                    if f not in files:
                        raise AssertionError(f"run (a) wrote {files}, no {f}")
                res["best_vs_cpu_detections"] = check_best_checkpoint(
                    cfg, str(Path(trainer.file_name) / "best_ckpt.pth"),
                    eval_imgs[:TRAINER_CHECK_N])
            if name == "a":
                run_a = rec
            if name == "a_resume":
                check_resume(trainer, rec, run_a)
                res["start_epoch"] = rec["start_epoch"]
                res["ema_updates_at_start"] = rec["ema_updates_at_start"]
            if name == "a":
                res["loader_alone_img_per_s"] = loader_rates(tcfg)
            log(f"trainer {name}: " + json.dumps(
                {k: v for k, v in res.items()
                 if k not in ("iter_ms", "loader_wait_ms")}))
            out[name] = res
            del trainer
    lines.append({"trainer": out})
    return totals


# ------------------------------------------- int8 serving and yolov3 (11)

# int8 dense rate of the H100 SXM (data sheet, dense)
H100_INT8_OPS = 1979e12
# Q1 / Q2 against their plain versions on the card: the int32 sums exactly
# (relu at a unit scale, float32(acc) on both sides); float32 outputs
# within Q_F32_RTOL |ref| (4 ulp); bf16 outputs within one bf16 ulp;
# requantized codes equal but for at most Q_CODE_FRAC of them, off by 1
# (an output within rounding of a code boundary: the activation's expf is
# CUDA's on both sides, but the tolerance does not count on it)
Q_F32_RTOL = 2.0 ** -21
Q_CODE_FRAC = 1e-4
INT8_SIZE = 640      # yolox-s and yolov3 (phase 11)
INT8_B = 8           # int8 serving checks at B 1 and INT8_B
V3_B = 2             # Q1 at yolov3's shapes
NANO_SIZE, NANO_B = 416, 8
INT8_CALIB_B = 2     # calibration frames
INT8_TIME_B = 32
# the card against the CPU port, int8 raw head outputs: rms over the
# output's spread, max |d|. The ladder's backbone is the same arithmetic
# on both (Q1 / Q2 equal their plain versions; the weights are quantized
# on the host; the epilogue's SiLU is float64 rounded once): a float32
# module differs only by cuDNN's float32 prediction convs
# (INT8_LADDER_F32_TOL; measured 6.6e-8). Where the outputs are bf16 (the
# HBM mode's prediction convs always, a bf16 module's) cuDNN and the CPU
# round them apart by a bf16 ulp, and in the HBM mode K1's tensor-core stem
# flips a code now and then: rms INT8_RMS_TOL (measured up to 0.0138, HBM
# float32: not far under JAX's HBM int8-against-float allowance of 0.02,
# as bf16 rounding is the same size), max two bf16 ulps of an output
# below 8 (measured 0.031). JAX's ladder allowance is 0.15.
INT8_LADDER_F32_TOL = 1e-5
INT8_RMS_TOL, INT8_MAX_TOL = 2e-2, 2 * 2.0 ** -5
# a table calibrated on the card against the CPU's: per entry, relative to
# its largest value (the float forward's roundings; measured 3.7e-6)
INT8_TABLE_TOL = 1e-4
# detections of int8 serving, card against CPU: the float32 ladder at the
# default (rtol 1e-4, atol 1e-2, labels equal). Where bf16 outputs decode
# (the HBM mode, bf16 modules) rows match by box within INT8_DET_BOX_TOL
# px and score within INT8_DET_SCORE_TOL (measured 4e-6 px, 0.011), and a
# label may differ: class confidences in bf16 tie exactly (argmax takes
# the first), so one bf16 rounding elsewhere moves the winner; on at most
# INT8_LABEL_FLIPS of the rows (measured 2 of 39)
INT8_DET_BOX_TOL, INT8_DET_SCORE_TOL, INT8_LABEL_FLIPS = 0.5, 0.03, 0.1
INT8_MIN_DETS = 10   # a comparison of fewer detections proves little


def int8_conv_bound(b, h, w, cin, cout, k, stride, groups=1, out_bytes=4):
    """The least ms of one int8 conv on the H100: 2 B Ho Wo Cout k^2
    Cin/groups operations at the dense int8 rate, or the codes in, the
    int8 weights and the output at the HBM rate, whichever is larger.
    Returns (ms, "operations" or "bytes")."""
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    ops = 2.0 * b * ho * wo * cout * k * k * cin / groups
    nbytes = (b * h * w * cin + cout * k * k * cin / groups
              + b * ho * wo * cout * out_bytes)
    t_ops, t_bytes = ops / H100_INT8_OPS, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def int8_conv_shapes(module, size, batch):
    """Counter of (B, Cin, Cout, H, W, k, stride, groups) over the convs
    the int8 modes run, read with hooks from one float forward at B 1 and
    given B `batch`: each BaseConv, the Focus stem as its folded 2k x 2k
    stride-2 conv on the 3-channel image."""
    from collections import Counter

    from yolox_tpu_torch.models.blocks import BaseConv, Focus

    shapes, hooks = Counter(), []

    def conv_hook(m, args):
        c, x = m.conv, args[0]
        shapes[(batch, x.shape[1], c.out_channels, x.shape[2], x.shape[3],
                c.kernel_size[0], c.stride[0], c.groups)] += 1

    def focus_hook(m, args):
        c, x = m.conv.conv, args[0]
        shapes[(batch, 3, c.out_channels, x.shape[1], x.shape[2],
                2 * c.kernel_size[0], 2, 1)] += 1

    for m in module.modules():
        if isinstance(m, Focus):
            hooks.append(m.register_forward_pre_hook(focus_hook))
        elif isinstance(m, BaseConv):
            hooks.append(m.register_forward_pre_hook(conv_hook))
    try:
        module(np.zeros((1, size, size, 3), np.uint8))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def q_inputs(gen, b, cin, cout, h, w, k, depthwise=False, offset=0):
    """Random int8 codes (B, Cin, H, W) stored channels_last `offset` bytes
    past an allocation, packed random int8 weights, an epilogue scale and
    bias that put the outputs near 1, a requant scale for amax ~3-6; on
    the generator's device."""
    import torch

    from yolox_tpu_torch.ops.int8_conv import pack_dw_weight, pack_weight

    dev = gen.device
    cout = cin if depthwise else cout
    buf = torch.randint(-127, 128, (b * h * w * cin + offset,),
                        generator=gen, dtype=torch.int8, device=dev)
    x = buf[offset:].view(b, h, w, cin).permute(0, 3, 1, 2)
    wq = torch.randint(-127, 128, (cout, 1 if depthwise else cin, k, k),
                       generator=gen, dtype=torch.int8, device=dev)
    w8 = pack_dw_weight(wq) if depthwise else pack_weight(wq)
    typical = 127.0 * 127.0 * (wq[0].numel() ** 0.5) / 3
    scale = (torch.rand(cout, generator=gen, device=dev) + 0.5) / typical
    bias = torch.rand(cout, generator=gen, device=dev) * 2 - 1
    out_scale = (torch.rand(cout, generator=gen, device=dev) + 1) * 3 / 127
    return x, w8, scale, bias, out_scale


def check_int8_conv(x, w, scale, bias, k, stride, out_scale, depthwise,
                    act="silu"):
    """Q1 (Q2 when `depthwise`) on one input against its plain version:
    float32, bf16 and requantized outputs at the Q_* tolerances, the
    unit-scale relu sums exactly; every kernel output twice, bit-equal.
    Returns (max |d| of the float32 output, share of codes off by 1)."""
    import torch

    from yolox_tpu_torch.ops.int8_conv import (
        epilogue_plain,
        int8_conv,
        int8_dwconv,
        plain_sums,
    )

    run = int8_dwconv if depthwise else int8_conv
    acc = plain_sums(x, w, k, stride, depthwise)
    ones, zeros = torch.ones_like(scale), torch.zeros_like(bias)
    f32, bf16 = torch.float32, torch.bfloat16
    err, off = 0.0, 0.0
    for kind, args in (("f32", (scale, bias, act, f32, None)),
                       ("bf16", (scale, bias, act, bf16, None)),
                       ("int8", (scale, bias, act, f32, out_scale)),
                       ("sums", (ones, zeros, "relu", f32, None))):
        got = run(x, w, args[0], args[1], k, stride, *args[2:])
        again = run(x, w, args[0], args[1], k, stride, *args[2:])
        ref = epilogue_plain(acc, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{kind}: two launches differ")
        if got.shape != ref.shape or got.dtype != ref.dtype or \
                not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"{kind}: {got.dtype} {tuple(got.shape)} "
                                 f"against {ref.dtype} {tuple(ref.shape)}")
        d = (got.float() - ref.float()).abs()
        if kind == "sums":
            ok = torch.equal(got, ref)
        elif kind == "f32":
            err = d.max().item()
            ok = bool((d <= Q_F32_RTOL * ref.abs()).all())
        elif kind == "bf16":
            ok = bool((d <= BF16_ULP * ref.float().abs()).all())
        else:
            off = (d > 0).float().mean().item()
            ok = d.max().item() <= 1 and off <= Q_CODE_FRAC
        if not ok:
            raise AssertionError(f"{'Q2' if depthwise else 'Q1'} {kind} "
                                 f"disagrees with its plain version: max "
                                 f"|d| {d.max().item()}")
    return err, off


# edge cases beside the models' shapes: (B, Cin, Cout, H, W, k, stride,
# groups, byte offset of the codes). Q1's tiles: M a multiple of neither
# BM 64 nor 128 (429 pixels); Cout 24 / 40 / 72 padded to an N tile, 264
# in two; K just under and over a k tile (112 and 144 against 128, 80
# against 64); the 3-channel stem at odd W; B 1 at 20x20; unaligned codes
# (the window patch); Cout 5 (stores of one output). Q2's: channel
# groups cut by C (24, 40, 72), M odd, B 1 at 20x20, unaligned codes at
# stride 2.
Q1_EDGE = ((2, 3, 32, 33, 35, 3, 1, 1, 0), (1, 3, 16, 30, 46, 6, 2, 1, 0),
           (2, 16, 32, 21, 19, 1, 1, 1, 0), (2, 16, 48, 17, 23, 3, 2, 1, 0),
           (2, 24, 40, 13, 11, 3, 2, 1, 0), (3, 64, 72, 9, 7, 3, 2, 1, 0),
           (2, 64, 128, 41, 39, 3, 2, 1, 1), (1, 48, 24, 15, 13, 1, 1, 1, 3),
           (3, 32, 64, 11, 13, 3, 1, 1, 0), (2, 32, 24, 9, 9, 1, 1, 1, 0),
           (2, 64, 40, 9, 11, 3, 1, 1, 0), (2, 128, 264, 10, 9, 1, 1, 1, 0),
           (2, 112, 64, 9, 9, 1, 1, 1, 0), (2, 16, 64, 9, 9, 3, 1, 1, 0),
           (2, 80, 32, 7, 9, 1, 1, 1, 0), (1, 3, 32, 63, 65, 6, 2, 1, 0),
           (1, 128, 128, 20, 20, 3, 1, 1, 0), (2, 64, 128, 17, 15, 3, 1, 1, 5),
           (2, 32, 5, 9, 7, 1, 1, 1, 0))
Q2_EDGE = ((2, 24, 24, 15, 17, 3, 2, 24, 0), (1, 40, 40, 9, 11, 3, 1, 40, 0),
           (2, 64, 64, 27, 25, 3, 2, 64, 5), (3, 64, 64, 11, 13, 3, 1, 64, 0),
           (2, 72, 72, 7, 9, 3, 1, 72, 0), (1, 64, 64, 20, 20, 3, 1, 64, 0),
           (1, 128, 128, 13, 13, 3, 2, 128, 9))


def phase_int8_kernels(cfgs):
    """The epilogue's branch-free SiLU and requant against their float64
    and IEEE-division forms on all 2^32 float inputs; Q1 at every
    distinct dense conv shape of yolox-s (B INT8_B), yolov3 (B V3_B) and
    nano (B NANO_B), Q2 at nano's depthwise shapes, and the edge cases
    (Q1_EDGE, Q2_EDGE), against their plain versions. Returns ({model:
    shape Counter}, Q1 max error, Q2 max error)."""
    import torch

    from yolox_tpu_torch import YoloxModule

    shapes = {}
    for name, seed, size, b in (("yolox_s", 4321, INT8_SIZE, INT8_B),
                                ("yolov3", 777, INT8_SIZE, V3_B),
                                ("yolox_nano", 1234, NANO_SIZE, NANO_B)):
        module = YoloxModule.from_config(cfgs[name], rng_seed=seed)
        shapes[name] = int8_conv_shapes(module, size, b)
        del module
    from yolox_tpu_torch.ops.int8_conv import epilogue_mismatches

    n = epilogue_mismatches("cuda")
    log(f"the epilogue's branch-free SiLU and requant against float64 y / "
        f"(1 + exp(-y)) rounded once and clamp(rint(__fdiv_rn(y, s))) at 8 "
        f"scales: {n} of 2^32 float inputs differ")
    if n:
        raise AssertionError("Q1 / Q2's epilogue differs from its defining "
                             "arithmetic")
    cases = sorted({s + (0,) for c in shapes.values() for s in c})
    cases += list(Q1_EDGE) + list(Q2_EDGE)
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"Q1": [0.0, 0.0, 0], "Q2": [0.0, 0.0, 0]}
    for b, cin, cout, h, w, k, stride, groups, offset in cases:
        dw = groups > 1
        x, w8, scale, bias, out_scale = q_inputs(gen, b, cin, cout, h, w, k,
                                                 dw, offset)
        err, off = check_int8_conv(x, w8, scale, bias, k, stride, out_scale,
                                   dw)
        q = worst["Q2" if dw else "Q1"]
        q[0], q[1], q[2] = max(q[0], err), max(q[1], off), q[2] + 1
        del x, w8
    log(f"Q1 at {worst['Q1'][2]} shapes, Q2 at {worst['Q2'][2]} (the models' "
        "and the edge cases): sums exact, float32 max |d| "
        f"{worst['Q1'][0]:.3g} / {worst['Q2'][0]:.3g}, codes off by 1 "
        f"{worst['Q1'][1]:.3g} / {worst['Q2'][1]:.3g} of the outputs, "
        "repeat launches bit-equal")
    log("distinct shapes (B, Cin, Cout, H, W, k, stride, groups): "
        + json.dumps({n: sorted(c) for n, c in shapes.items()}))
    return shapes, worst["Q1"][0], worst["Q2"][0]


def int8_raw(module, x, mode, table):
    """Raw head outputs (a float32 numpy array per level) of `module` in
    int8 `mode` at `table`."""
    import torch

    with module._int8_mode(mode, table), torch.inference_mode():
        outs, _, _ = module.head.forward_raw_levels(
            module.backbone(module._image_batch(x, mode)))
    return [o.float().cpu().numpy() for o in outs]


def match_rows_free_labels(g, w, thr=None):
    """Detection rows (n, 7) of one image, box then two score factors
    (obj, cls_conf; or score, 1) then label, against a reference's: every
    reference row has a partner within `INT8_DET_BOX_TOL` px and
    `INT8_DET_SCORE_TOL` of score, of its label where one qualifies. With
    a threshold `thr`, rows of either side scoring within the score
    tolerance of it may go unpaired (the two devices' scores may fall on
    either side of it). Returns (label flips, unpaired rows, max box |d|,
    max score |d|)."""
    def near(score):
        return thr is not None and score <= thr + INT8_DET_SCORE_TOL

    if thr is None and g.shape != w.shape:
        raise AssertionError(f"{len(g)} detections against {len(w)}")
    free = np.ones(len(g), bool)
    flips = unpaired = 0
    box_d = score_d = 0.0
    for row in w:
        bd = np.abs(g[:, :4] - row[:4]).max(1) if len(g) else np.zeros(0)
        sd = np.abs(g[:, 4] * g[:, 5] - row[4] * row[5])
        ok = free & (bd <= INT8_DET_BOX_TOL) & (sd <= INT8_DET_SCORE_TOL)
        if not ok.any():
            if near(row[4] * row[5]):
                unpaired += 1
                continue
            raise AssertionError(f"row {row.tolist()} has no partner")
        same = ok & (g[:, 6] == row[6])
        j = int(np.argmax(same if same.any() else ok))
        free[j] = False
        flips += int(g[j, 6] != row[6])
        box_d, score_d = max(box_d, bd[j]), max(score_d, sd[j])
    for row in g[free]:
        if not near(row[4] * row[5]):
            raise AssertionError(f"row {row.tolist()} has no partner")
        unpaired += 1
    return flips, unpaired, float(box_d), float(score_d)


def match_int8_detections(got, want, thr):
    """`match_rows_free_labels` over the images of two devices'
    `Detections` lists at threshold `thr`; returns (paired rows, label
    flips, unpaired rows, max box |d|, max score |d|)."""
    rows = flips = unpaired = 0
    box_d = score_d = 0.0
    for g, w in zip(detections_as_rows(got), detections_as_rows(want)):
        f, u, b, sc = match_rows_free_labels(g, w, thr)
        rows, flips, unpaired = rows + len(w) - u, flips + f, unpaired + u
        box_d, score_d = max(box_d, b), max(score_d, sc)
    return rows, flips, unpaired, box_d, score_d


def raw_close(got, want):
    """(rms over the spread, max |d|) of raw outputs, worst level."""
    rms = max(float(np.sqrt(((g - w) ** 2).mean()) / (w.std() + 1e-9))
              for g, w in zip(got, want))
    return rms, max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def _only(counters, **launches):
    """The launch counts a run should read: `launches`, 0 for the rest."""
    return {k: launches.get(k, 0) for k in counters}


def int8_card_vs_cpu(name, gpu, cpu, table, modes, frames, n_q1, n_q2,
                     threshold=None):
    """One model in each int8 mode: raw outputs at B 1 and on all
    `frames`, card against CPU; `Yolox.__call__` on the card (its
    `int8_qtab` / `int8_hbm_qtab` set) for 1 frame and all of `frames`
    with the launch counters
    read around it, against the CPU's detections, at `threshold` (default:
    in a gap of the CPU's scores). Returns {mode: (rms, max |d|,
    launches)}."""
    import torch

    from yolox_tpu_torch import Yolox, YoloxProcessor

    out = {}
    counters = _launch_counters()
    bf16 = gpu.dtype == torch.bfloat16
    reqs = [frames[:1], frames]
    for mode in modes:
        attr = "int8_qtab" if mode == "ladder" else "int8_hbm_qtab"
        worst, scores = (0.0, 0.0), []
        for f in reqs:
            x = np.stack(f)
            raws = [int8_raw(m, x, mode, table) for m in (gpu, cpu)]
            r = raw_close(*raws)
            worst = tuple(max(u, v) for u, v in zip(worst, r))
            scores.append([np.concatenate(o, 1).reshape(-1, 85)
                           for o in raws])
        exact = mode == "ladder" and not bf16
        if not (worst[0] <= (INT8_LADDER_F32_TOL if exact else INT8_RMS_TOL)
                and worst[1] <= INT8_MAX_TOL):
            raise AssertionError(f"{name} int8 {mode}: card against CPU "
                                 f"rms {worst[0]:.3g}, max {worst[1]:.3g}")
        card, host = (np.concatenate([s[i] for s in scores]) for i in (0, 1))
        card, host = (o[:, 4] * o[:, 5:].max(-1) for o in (card, host))
        log(f"{name} int8 {mode} {str(gpu.dtype).split('.')[-1]}: raw "
            f"outputs card against CPU rms {worst[0]:.3g}, max "
            f"{worst[1]:.3g}, scores max |d| {np.abs(card - host).max():.3g}")
        if threshold is None:
            thr, gap = gap_threshold(host,
                                     *np.quantile(host, [0.99, 0.999]))
            if exact and gap < 1e-3:
                raise AssertionError(f"{name} int8 {mode}: no score gap")
        else:
            thr = threshold
        ys = []
        for m in (gpu, cpu):
            y = Yolox(m, YoloxProcessor(m.config))
            setattr(y, attr, table)
            ys.append(y)
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        got = [ys[0](f, threshold=thr) for f in reqs]
        torch.cuda.synchronize()
        n = {k: f.launches for k, f in counters.items()}
        # the HBM mode keeps the Focus stem float (K1), the ladder runs its
        # folded conv on Q1
        hbm = int(mode == "hbm")
        want = _only(counters, int8_conv=2 * (n_q1 - hbm),
                     int8_dwconv=2 * n_q2, stem=2 * hbm, nms=2)
        if n != want:
            raise AssertionError(f"{name} int8 {mode}: launches {n}, want "
                                 f"{want}")
        n_dets, flips, unpaired, box_d, score_d = 0, 0, 0, 0.0, 0.0
        for f, dets in zip(reqs, got):
            want_dets = ys[1](f, threshold=thr)
            if exact:
                assert_detections_match(dets, want_dets)
                n_dets += sum(len(d["labels"]) for d in dets)
                continue
            r = match_int8_detections(dets, want_dets, thr)
            n_dets, flips, unpaired = (n_dets + r[0], flips + r[1],
                                       unpaired + r[2])
            box_d, score_d = max(box_d, r[3]), max(score_d, r[4])
        if n_dets < INT8_MIN_DETS or flips > INT8_LABEL_FLIPS * n_dets:
            raise AssertionError(f"{name} int8 {mode}: {n_dets} detections "
                                 f"paired, {flips} labels differ")
        log(f"{name} int8 {mode}: Yolox.__call__ (1 and {len(frames)} "
            "frames) "
            f"launches {n}; {n_dets} detections at {thr:.4f} match the CPU"
            + ("" if exact else f" ({unpaired} within {INT8_DET_SCORE_TOL} "
               f"of the threshold unpaired, labels differ on {flips}, box "
               f"max |d| {box_d:.3g} px, score {score_d:.3g})"))
        out[mode] = (worst[0], worst[1], n)
    return out


def phase_yolov3(cfg, rng):
    """yolov3 at full width and depth, 640 px: `YoloxModule.__call__`
    against `tests/golden/yolov3_seed777.npz`, then `Yolox.__call__` on 1
    and 3 uint8 frames against the CPU with the launch counters read
    around it (K2 once a call, K1 and Q1 never). Returns (launches, the
    card's module, a threshold)."""
    import torch

    from yolox_tpu_torch import Yolox, YoloxModule, YoloxProcessor
    from yolox_tpu_torch.ops.nms import postprocess_device

    gpu_mod = YoloxModule.from_config(cfg, rng_seed=777)
    x = np.random.default_rng(97).uniform(0, 255, (2, 640, 640, 3)).astype(
        np.float32)
    out = gpu_mod(x)
    want = np.load(GOLDEN / "yolov3_seed777.npz")
    np.testing.assert_allclose(out.cpu().numpy()[:, ::997, :],
                               want["head_slice"], rtol=1e-4, atol=1e-3)
    dets, valid = postprocess_device(out, 80, 1e-5, 0.65, False, 64)
    assert_dets_match(dets.cpu().numpy(), valid.cpu().numpy(), want["dets"],
                      want["valid"], tie=GOLDEN_TIE)
    log("yolov3 YoloxModule.__call__ matches tests/golden/yolov3_seed777.npz")
    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=777, device="cpu"),
        rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8))
    gpu_mod.load_params(cpu_mod.state_dict())
    gpu, cpu = (Yolox(m, YoloxProcessor(cfg)) for m in (gpu_mod, cpu_mod))
    requests = [_frames(rng, 1), _frames(rng, 3)]
    cuts = [gap_threshold(anchor_scores(cpu_mod, cpu.processor(
        f, dtype=np.uint8)), 0.25, 0.45) for f in requests]
    if min(g for _, g in cuts) < 1e-3:
        raise AssertionError("no score gap wide enough to compare devices")
    counters = _launch_counters()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    got = [gpu(f, threshold=t) for f, (t, _) in zip(requests, cuts)]
    torch.cuda.synchronize()
    n = {k: f.launches for k, f in counters.items()}
    if n != _only(counters, nms=2):
        raise AssertionError(f"yolov3 serving launched {n}")
    n_dets = 0
    for f, (t, _), dets in zip(requests, cuts, got):
        assert_detections_match(dets, cpu(f, threshold=t))
        n_dets += sum(len(d["labels"]) for d in dets)
    log(f"yolov3 Yolox.__call__ (1 and 3 frames) matches the CPU: {n_dets} "
        f"detections, launches {n}")
    return n, gpu_mod, cuts[1][0]


def phase_int8_serve(cfg, rng, n_q1):
    """int8 serving of yolox-s at full width, INT8_SIZE px: the table
    calibrated on the CPU (INT8_CALIB_B frames) and used on both sides;
    a table calibrated on the card against it; both modes for float32 and
    bf16 modules (`int8_card_vs_cpu`). Returns (results, the table, the
    card's bf16 module)."""
    import torch

    from yolox_tpu_torch import YoloxModule

    calib = rng.integers(0, 256, (INT8_CALIB_B, INT8_SIZE, INT8_SIZE, 3),
                         dtype=np.uint8)
    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=4321, device="cpu"), calib)
    table = cpu_mod.calibrate_int8(calib)
    gpu_mod = YoloxModule.from_config(cfg, rng_seed=4321)
    gpu_mod.load_params(cpu_mod.state_dict())
    card_table = gpu_mod.calibrate_int8(torch.from_numpy(calib).cuda())
    table_err = max(float((card_table[k].cpu() - v).abs().max()
                          / v.abs().max()) for k, v in table.items())
    log(f"yolox-s table: {len(table)} entries; calibrated on the card it "
        f"differs from the CPU's by {table_err:.3g} of an entry's largest")
    if set(card_table) != set(table) or table_err > INT8_TABLE_TOL:
        raise AssertionError("the card's calibration disagrees with the CPU")
    frames = _frames(rng, INT8_B)
    res = {"table_rel_err": table_err}
    mods = {}
    for dtype in (torch.float32, torch.bfloat16):
        pair = []
        for device in ("cuda", "cpu"):
            m = YoloxModule.from_config(cfg, rng_seed=4321, dtype=dtype,
                                        device=device)
            m.load_params(cpu_mod.state_dict())
            pair.append(m)
        key = str(dtype).split(".")[-1]
        res[key] = int8_card_vs_cpu("yolox-s", *pair, table,
                                    ("ladder", "hbm"), frames, n_q1, 0)
        mods[key] = pair[0]
    return res, table, mods["bfloat16"]


def phase_int8_nano(cfg, rng, n_q1, n_q2):
    """nano int8 HBM at NANO_SIZE px, B 1 and INT8_B, card against CPU
    (Q2 once per depthwise conv a call). Returns (results, the table, the
    card's module)."""
    from yolox_tpu_torch import YoloxModule

    frames = [rng.integers(0, 256, (NANO_SIZE, NANO_SIZE, 3), dtype=np.uint8)
              for _ in range(INT8_B)]
    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=1234, device="cpu"),
        np.stack(frames[:INT8_CALIB_B]))
    table = cpu_mod.calibrate_int8(np.stack(frames[:INT8_CALIB_B]))
    gpu_mod = YoloxModule.from_config(cfg, rng_seed=1234)
    gpu_mod.load_params(cpu_mod.state_dict())
    res = int8_card_vs_cpu("nano", gpu_mod, cpu_mod, table, ("hbm",), frames,
                           n_q1, n_q2)
    return res, table, gpu_mod


def serve_time(module, b, reps, threshold, **kw):
    """Median wall ms of `serve` on a host uint8 batch of B `b` (detections
    copied to the host), after 3 warm-up calls; device ms per call by
    kernel (torch.profiler), when it reaches the card."""
    import torch

    x = np.random.default_rng(b).integers(0, 256, (b, INT8_SIZE, INT8_SIZE,
                                                   3), dtype=np.uint8)

    def call():
        dets, valid = module.serve(x, conf_thre=threshold, max_det=1024, **kw)
        dets.cpu(), valid.cpu()

    samples = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        if i >= 3:
            samples.append(time.perf_counter() - t0)
    med = float(np.median(samples))
    t = {"median_ms": 1e3 * med, "img_per_s": b / med}
    try:
        dev_ms, top = device_time(call)
    except Exception as e:  # the profiler may not reach the card
        log(f"device breakdown: not measured ({e})")
        return t, []
    t.update(device_ms=dev_ms, device_busy=dev_ms / (1e3 * med))
    return t, top


def capture_int8_convs(module, x, threshold, **kw):
    """The arguments of every Q1 and Q2 launch of one serve call."""
    import torch

    from yolox_tpu_torch.ops import quant

    calls, real = [], (quant.int8_conv, quant.int8_dwconv)

    def spy(dw):
        def run(*args):
            calls.append((dw, args))
            return real[dw](*args)
        return run

    quant.int8_conv, quant.int8_dwconv = spy(0), spy(1)
    try:
        module.serve(x, conf_thre=threshold, max_det=1024, **kw)
    finally:
        quant.int8_conv, quant.int8_dwconv = real
    torch.cuda.synchronize()
    return calls


def _conv_key(dw, args):
    x, w, _, _, k, stride = args[:6]
    b, cin, h, wd = x.shape
    cout = cin if dw else w.shape[0]
    return (b, cin, cout, h, wd, k, stride, cin if dw else 1)


def int8_conv_times(calls, depth_ms):
    """Q1 (or Q2) over the launches of one serve call (`calls`): the
    kernels' device ms (profiler, `depth_ms`) beside the sum of the
    launches replayed back to back (`queued_ms`), the same with the relu
    epilogue (the float64 SiLU's share), the plain versions, the bound and
    cuDNN's bf16 conv of each shape, and for Q1 `torch._int_mm` over an
    im2col of the codes summed over the launches (with the count of
    launches whose shape it refuses); and the same per launch at the
    largest (by bound) and the most frequent shape."""
    import collections

    import torch
    import torch.nn.functional as F

    from yolox_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_plain,
        int8_dwconv,
        int8_dwconv_plain,
    )

    def kernel(dw, args):
        return (int8_dwconv if dw else int8_conv)(*args)

    def plain(dw, args):
        return (int8_dwconv_plain if dw else int8_conv_plain)(*args)

    def library(dw, args):
        """cuDNN's bf16 conv of the same shape on channels_last bf16."""
        x, w, _, _, k, stride = args[:6]
        xb = x.to(torch.bfloat16)
        cin = x.shape[1]
        cout = cin if dw else w.shape[0]
        wb = torch.ones((cout, 1 if dw else cin, k, k), dtype=torch.bfloat16,
                        device=x.device).contiguous(
                            memory_format=torch.channels_last)
        return lambda: F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2,
                                groups=cin if dw else 1)

    def bound(dw, args):
        b, cin, cout, h, w, k, stride, g = _conv_key(dw, args)
        out_bytes = 1 if args[8] is not None else (
            2 if args[7] == torch.bfloat16 else 4)
        return int8_conv_bound(b, h, w, cin, cout, k, stride, g, out_bytes)

    libs = [library(dw, a) for dw, a in calls]

    def replay():
        for dw, a in calls:
            kernel(dw, a)

    def replay_library():
        for f in libs:
            f()

    t = {"launches": len(calls), "ms": cuda_ms(replay, 3),
         "device_ms": queued_ms(replay, 3), "profiler_device_ms": depth_ms,
         "plain_ms": cuda_ms(lambda: [plain(dw, a) for dw, a in calls], 1,
                             warmup=1),
         "bound_ms": sum(bound(dw, a)[0] for dw, a in calls),
         "library_ms": cuda_ms(replay_library, 3),
         "library_device_ms": queued_ms(replay_library, 3)}
    t["bound_by"] = collections.Counter(
        bound(dw, a)[1] for dw, a in calls).most_common(1)[0][0]
    count = collections.Counter(_conv_key(dw, a) for dw, a in calls)
    first = {}
    for dw, a in calls:
        first.setdefault(_conv_key(dw, a), (dw, a))
    # the same launches with the relu epilogue: what the float64 SiLU costs
    relu = [(dw, a[:6] + ("relu",) + a[7:]) for dw, a in calls]
    t["relu_device_ms"] = queued_ms(lambda: [kernel(dw, a) for dw, a in relu],
                                    3)
    if not any(dw for dw, _ in calls):
        # torch._int_mm over the call: each shape's time times its count
        mm = {key: int_mm_ms(a) for key, (_, a) in first.items()}
        t["int_mm_ms"] = sum(v * count[key] for key, v in mm.items()
                             if v is not None)
        t["int_mm_refused"] = sum(count[key] for key, v in mm.items()
                                  if v is None)
    largest = max(first.values(), key=lambda c: bound(*c)[0])
    frequent = first[count.most_common(1)[0][0]]
    for label, (dw, a) in (("largest", largest), ("most_frequent", frequent)):
        lib = library(dw, a)
        s = {"shape": list(_conv_key(dw, a)),
             "count": count[_conv_key(dw, a)],
             "ms": cuda_ms(lambda: kernel(dw, a), 20),
             "device_ms": queued_ms(lambda: kernel(dw, a), 20),
             "plain_ms": cuda_ms(lambda: plain(dw, a), 2, warmup=1),
             "library_ms": cuda_ms(lib, 20),
             "library_device_ms": queued_ms(lib, 20)}
        s["bound_ms"], s["bound_by"] = bound(dw, a)
        if not dw:
            s["int_mm_ms"] = int_mm_ms(a)
        t[label] = s
    return t


def int_mm_ms(args):
    """Device ms of `torch._int_mm` on an im2col of one Q1 launch's codes
    (M = B Ho Wo, K = k^2 Cin padded as Q1 packs it, N = Cout), the
    im2col made before the timing (in float16, which holds every int8,
    then cast); None where `_int_mm` refuses the shape."""
    import torch
    import torch.nn.functional as F

    x, w, _, _, k, stride = args[:6]
    cols = F.unfold(x.half(), k, padding=(k - 1) // 2, stride=stride)
    cols = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
    cols = F.pad(cols, (0, w.shape[1] - cols.shape[1])).contiguous()
    wt = w.t()  # (Kp, Cout), column-major
    try:
        return queued_ms(lambda: torch._int_mm(cols, wt), 20)
    except RuntimeError as e:
        log(f"torch._int_mm refuses {tuple(cols.shape)} x {tuple(wt.shape)}: "
            f"{str(e).splitlines()[0]}")
        return None


def int8_times(v3_mod, s_bf16, nano_mod, s_table, nano_table, threshold):
    """Serve latency (B 1) and throughput (B INT8_TIME_B) of yolov3 in
    float32 and bf16 and of yolox-s int8 (ladder and HBM, bf16 module);
    Q1 over one B INT8_TIME_B ladder call (and the device ms of Q1 over a
    B 1 ladder call) and Q2 over one nano HBM call (`int8_conv_times`)."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.ops.int8_conv import int8_conv

    out = {"serve": {}}
    v3_bf16 = YoloxModule.from_config(v3_mod.config, rng_seed=777,
                                      dtype=torch.bfloat16)
    v3_bf16.load_params(v3_mod.state_dict())
    q1_dev = {}
    for key, mod, kw in (("yolov3_float32", v3_mod, {}),
                         ("yolov3_bfloat16", v3_bf16, {}),
                         ("yolox_s_int8_ladder_bf16", s_bf16,
                          {"int8_qtab": s_table}),
                         ("yolox_s_int8_hbm_bf16", s_bf16,
                          {"int8_hbm_qtab": s_table})):
        for b, reps in ((1, 15), (INT8_TIME_B, 4)):
            t, top = serve_time(mod, b, reps, threshold, **kw)
            name = f"{key}_b{b}"
            q1 = sum(v for k, v in top if "q1_kernel" in k)
            if kw:
                t["q1_device_ms"] = q1
                q1_dev[name] = q1
            out["serve"][name] = t
            log(f"serve {name}: {t}; top kernels (ms per call) "
                + json.dumps([(k[:50], round(v, 4)) for k, v in top[:6]]))
    del v3_bf16
    x = np.random.default_rng(5).integers(0, 256, (INT8_TIME_B, INT8_SIZE,
                                                   INT8_SIZE, 3), np.uint8)
    calls = capture_int8_convs(s_bf16, x, threshold, int8_qtab=s_table)
    out["q1"] = int8_conv_times(
        calls, q1_dev.get(f"yolox_s_int8_ladder_bf16_b{INT8_TIME_B}"))
    del calls
    calls = capture_int8_convs(s_bf16, x[:1], threshold, int8_qtab=s_table)
    out["q1"]["b1_launches"] = len(calls)
    out["q1"]["b1_device_ms"] = queued_ms(
        lambda: [int8_conv(*a) for _, a in calls], 5)
    log(f"Q1 over one B {INT8_TIME_B} ladder call (and a B 1 one): "
        f"{out['q1']}")
    del calls
    xn = np.random.default_rng(6).integers(0, 256, (INT8_TIME_B, NANO_SIZE,
                                                    NANO_SIZE, 3), np.uint8)
    calls = [c for c in capture_int8_convs(nano_mod, xn, threshold,
                                           int8_hbm_qtab=nano_table) if c[0]]
    _, top = device_time(lambda: nano_mod.serve(
        xn, conf_thre=threshold, max_det=1024, int8_hbm_qtab=nano_table))
    out["q2"] = int8_conv_times(calls, sum(v for k, v in top
                                           if "q2_kernel" in k))
    log(f"Q2 over one nano B {INT8_TIME_B} HBM call: {out['q2']}")
    return out


def run_int8(cfg, rng, lines):
    """Phase 11: Q1 / Q2 against their plain versions, yolov3, int8
    serving of yolox-s (both modes, float32 and bf16) and nano (HBM), the
    times. Returns the kernels-line entries of Q1 and Q2."""
    from yolox_tpu_torch import YoloxConfig

    t0 = time.perf_counter()
    cfgs = {n: YoloxConfig.get_named_config(n)
            for n in ("yolox_s", "yolov3", "yolox_nano")}
    shapes, q1_err, q2_err = phase_int8_kernels(cfgs)
    v3_launches, v3_mod, v3_thr = phase_yolov3(cfgs["yolov3"], rng)
    n_q1 = sum(shapes["yolox_s"].values())
    serve, s_table, s_bf16 = phase_int8_serve(cfg, rng, n_q1)
    nano_q1 = sum(n for s, n in shapes["yolox_nano"].items() if s[-1] == 1)
    nano_q2 = sum(n for s, n in shapes["yolox_nano"].items() if s[-1] > 1)
    nano, nano_table, nano_mod = phase_int8_nano(cfgs["yolox_nano"], rng,
                                                 nano_q1, nano_q2)
    log(f"phase 11 checks: {time.perf_counter() - t0:.1f} s")
    times = int8_times(v3_mod, s_bf16, nano_mod, s_table, nano_table, v3_thr)
    lines.append({"int8": {"yolox_s": serve, "nano": nano,
                           "yolov3_launches": v3_launches,
                           "serve": times["serve"]}})
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    keys = ("ms", "device_ms", "profiler_device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    entries = []
    for name, q, err, launches, note in (
            ("int8_conv", times["q1"], q1_err,
             sum(r[2]["int8_conv"] for d in ("float32", "bfloat16")
                 for r in serve[d].values()),
             f"sum over the launches of one B {INT8_TIME_B} yolox-s int8 "
             f"ladder serve call, bf16 module, {INT8_SIZE} px"),
            ("int8_dwconv", times["q2"], q2_err,
             nano["hbm"][2]["int8_dwconv"],
             f"sum over the launches of one B {INT8_TIME_B} nano int8 HBM "
             f"serve call, {NANO_SIZE} px")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "yolox_tpu_torch/csrc/int8_conv.cu",
            # no Pallas kernel: JAX's int8 conv is lax.conv_general_dilated
            # with int32 accumulation (ladder :127, HBM :230)
            "replaces": "yolox_tpu/ops/quant.py:127",
            "launches": launches, "max_abs_err": err,
            **{k: q[k] for k in keys}, "unit": note,
            **{k: q[k] for k in ("relu_device_ms", "int_mm_ms",
                                 "int_mm_refused", "b1_device_ms",
                                 "b1_launches") if k in q},
            "largest": q["largest"], "most_frequent": q["most_frequent"]})
    return entries


# ------------------------------------------------------------ the CLI phase

CLI_N = 16           # images of the synthetic COCO set (train and val)
CLI_B = 8            # eval / train batch
# the timed evaluation: the val set CLI_TIME_SETS times over (160 images,
# links to the same files) at B 32, as phase 9, so that the evaluation
# and not the command's start-up sets the images/s
CLI_TIME_SETS = 10
CLI_TIME_N = CLI_N * CLI_TIME_SETS
CLI_TIME_B = 32
CLI_VIDEO = 6        # frames of the MJPG clip, 1280 x 720
CLI_TIME_REPS = 10   # timed calls of an exported program and of eager serve
CLI_OP_CALLS = 500   # calls timed for the operators' host cost
CLI_CONF = 0.3       # demo / export thresholds (spread scores: ~0-0.6)
CLI_CFG = """
from yolox_tpu_torch.config import YoloxS


class CliConfig(YoloxS):
    def __init__(self):
        super().__init__()
        self.data_dir = {root!r}
        self.output_dir = {out!r}
        self.data_num_workers = 2
        self.max_epoch = 2
        self.no_aug_epochs = 0
        self.warmup_epochs = 1
        self.eval_interval = 1
        self.print_interval = 1
        self.multiscale_range = 0
        self.save_history_ckpt = False


class CliTimeConfig(CliConfig):
    def __init__(self):
        super().__init__()
        self.data_dir = {timed!r}
        self.data_num_workers = 4
"""


def cli_data(root, rng, model):
    """The phase's files under `root`: CLI_N seeded BGR images of
    `EVAL_SHAPES` written with cv2 as the train2017 / val2017 sets (one
    annotation file for both) whose boxes are `model`'s own detections at
    CLI_CONF on the decoded files (a random box where it finds none), the
    timed val set `root/timed` (CLI_TIME_N links to them, CLI_TIME_SETS
    times over), a demo folder (two of them and a 1280 x 720 frame) and a
    CLI_VIDEO-frame MJPG clip at 1280 x 720; the config module `cli_cfg`
    (`CliConfig`, and `CliTimeConfig` on the timed set) on `sys.path`.
    Returns (demo folder, clip path)."""
    import cv2

    images = eval_images(CLI_N, seed=12)
    for split in ("train2017", "val2017"):
        (Path(root) / split).mkdir()
        for i, im in enumerate(images):
            cv2.imwrite(str(Path(root) / split / f"{i:012}.jpg"), im)
    decoded = [cv2.imread(str(Path(root) / "val2017" / f"{i:012}.jpg"))
               for i in range(CLI_N)]
    boxes = []
    for im, dets in zip(decoded, model(decoded, threshold=CLI_CONF)):
        rows = [list(b) + [c] for b, c in zip(dets["bboxes"],
                                               dets["labels"])]
        if not rows:
            h, w = im.shape[:2]
            rows = [[w / 4, h / 4, w / 2, h / 2, int(rng.integers(80))]]
        boxes.append(np.clip(np.asarray(rows, np.float64), 0, None))
    for split in ("train2017", "val2017"):
        coco_json(Path(root) / "annotations" / f"instances_{split}.json",
                  images, boxes)
    timed = Path(root) / "timed"
    (timed / "val2017").mkdir(parents=True)
    for i in range(CLI_TIME_N):
        os.symlink(Path(root) / "val2017" / f"{i % CLI_N:012}.jpg",
                   timed / "val2017" / f"{i:012}.jpg")
    coco_json(timed / "annotations" / "instances_val2017.json",
              images * CLI_TIME_SETS, boxes * CLI_TIME_SETS)
    demo = Path(root) / "demo"
    demo.mkdir()
    cv2.imwrite(str(demo / "a.jpg"), images[0])
    cv2.imwrite(str(demo / "b.jpg"), images[1])
    cv2.imwrite(str(demo / "c_1280x720.jpg"),
                rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8))
    clip = str(Path(root) / "clip.avi")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (1280, 720))
    for _ in range(CLI_VIDEO):
        writer.write(rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8))
    writer.release()
    (Path(root) / "cli_cfg.py").write_text(CLI_CFG.format(
        root=str(root), out=str(Path(root) / "out"), timed=str(timed)))
    sys.path.insert(0, str(root))
    log(f"cli set: {CLI_N} images, {sum(map(len, boxes))} boxes (the "
        f"model's detections at {CLI_CONF})")
    return demo, clip


class CliRuns:
    """`yolox_tpu_torch.cli.main(argv)` with the launch counters set to 0
    just before it and read just after; records each run, the
    `YoloxConfig.eval` results and seconds inside it, and the parts of
    each COCO evaluation (`parts`: the evaluator's own timed inference
    seconds, dispatch and fetch of every batch but the last, and the
    seconds of `evaluate_prediction`, COCOeval's)."""

    def __init__(self):
        import yolox_tpu_torch
        from yolox_tpu_torch.evaluators.coco_evaluator import CocoEvaluator

        self.counters = _launch_counters()
        self.runs, self.evals, self.eval_s, self.parts = [], [], [], []
        self.cls, self.ev_cls = yolox_tpu_torch.YoloxConfig, CocoEvaluator
        self.original_eval = self.cls.eval
        self.original_predict = CocoEvaluator.evaluate_prediction

        def record(cfg, *a, **kw):
            _card_sync()
            t0 = time.perf_counter()
            out = self.original_eval(cfg, *a, **kw)
            _card_sync()
            self.evals.append(out)
            self.eval_s.append(time.perf_counter() - t0)
            return out

        def predict(ev, data, statistics):
            t0 = time.perf_counter()
            out = self.original_predict(ev, data, statistics)
            self.parts.append({"inference_s": float(statistics[0]),
                               "timed_batches": int(statistics[2]),
                               "cocoeval_s": time.perf_counter() - t0})
            return out

        self.cls.eval = record
        CocoEvaluator.evaluate_prediction = predict

    def close(self):
        self.cls.eval = self.original_eval
        self.ev_cls.evaluate_prediction = self.original_predict

    def reset(self):
        _card_sync()
        for f in self.counters.values():
            f.launches = 0

    def read(self):
        _card_sync()
        return {k: f.launches for k, f in self.counters.items()}

    def __call__(self, name, argv, want=None, call=None, reference=False):
        """Run `argv` (or `call()`), check its launches against `want`
        (the counters not named there 0); returns what it returned. A
        `reference` run (what a command is held to) is recorded but left
        out of the phase's launch totals."""
        from yolox_tpu_torch.cli import main as cli_main

        self.reset()
        t0 = time.perf_counter()
        out = call() if call is not None else cli_main(argv)
        wall = time.perf_counter() - t0
        got = self.read()
        if call is None and out != 0:
            raise AssertionError(f"cli {name}: exit code {out}")
        if want is not None and got != _only(self.counters, **want):
            raise AssertionError(f"cli {name}: launches {got}, want {want}")
        self.runs.append({"run": name, "s": wall, "launches": got,
                          "reference": reference})
        log(f"cli {name}: {wall:.1f} s, launches "
            + json.dumps({k: v for k, v in got.items() if v}))
        return out


# the loader rates: both routes over the same batches of the timed set,
# the workers' start-up and the first batch excluded (the pickled route
# runs ~20 img/s: its whole set took ~16 s)
CLI_LOADER_BATCHES = 4


def eval_loader_rates(tcfg):
    """The evaluation loader alone, images/s: as `get_eval_loader` builds
    it (batches through shared memory), and with the batches pickled
    through the workers' pipes (`collate`'s numpy arrays), the route it
    took before. Each is timed over batches 2 .. CLI_LOADER_BATCHES + 1
    of the timed set, from the first batch's arrival."""
    import itertools

    from torch.utils.data import DataLoader as TorchDataLoader

    from yolox_tpu_torch.data.dataloading import collate
    from yolox_tpu_torch.data.samplers import SequentialBatchSampler

    ds = tcfg.get_eval_dataset()
    if len(ds) < (CLI_LOADER_BATCHES + 1) * CLI_TIME_B:
        raise AssertionError(f"the timed set has {len(ds)} images")
    pickled = TorchDataLoader(
        ds, batch_sampler=SequentialBatchSampler(len(ds), CLI_TIME_B),
        num_workers=tcfg.data_num_workers, collate_fn=collate)
    out = {}
    for key, loader in (("loader_alone_img_per_s",
                         tcfg.get_eval_loader(CLI_TIME_B)),
                        ("loader_alone_pickled_img_per_s", pickled)):
        batches = iter(loader)
        next(batches)
        t0 = time.perf_counter()
        n = sum(len(b[0]) for b in itertools.islice(batches,
                                                    CLI_LOADER_BATCHES))
        out[key] = n / (time.perf_counter() - t0)
        del batches   # its workers stop
    log(f"evaluation loader alone, {tcfg.data_num_workers} workers, "
        f"batches 2-{CLI_LOADER_BATCHES + 1} of {CLI_TIME_B}, img/s: {out}")
    return out


def cli_eval(runs, name, ckpt, cfg_cls, time_name, time_cls):
    """`eval` in float32 (against `config.eval` on the same module and
    set), bf16 and int8 HBM on the CLI_N-image set at B CLI_B (AP50:95,
    AP50 and launches); then the same three on the timed set of
    CLI_TIME_N images at B CLI_TIME_B, between two `config.eval` calls
    of the float32 module (the reference): images/s of each evaluation
    call (loader, inference and the COCO statistics), the command's wall
    seconds and what it spends outside that call (start-up: config,
    module, checkpoint, loader)."""
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    batches = -(-CLI_N // CLI_B)
    argv = ["eval", "-c", name, "--ckpt", ckpt, "-b", str(CLI_B)]
    res = {}
    n = len(runs.evals)
    runs("eval f32", argv, {"stem": batches, "nms": batches})
    ap, ap50, _ = runs.evals[n]
    cfg = cfg_cls()
    module = YoloxModule.from_config(cfg, device=CARD)
    module.load_params(load_checkpoint(ckpt)["model"])
    want_ap, want_ap50, _ = runs("config.eval f32", None, {
        "stem": batches, "nms": batches}, call=lambda: cfg.eval(
            module, cfg.get_evaluator(CLI_B)), reference=True)
    log(f"cli eval f32: AP50:95 {float(ap)!r} AP50 {float(ap50)!r}; "
        f"config.eval {float(want_ap)!r} / {float(want_ap50)!r}")
    if (ap, ap50) != (want_ap, want_ap50):
        raise AssertionError("the eval command's float32 AP differs from "
                             "config.eval on the same module and set")
    res["f32"] = {"ap50_95": float(ap), "ap50": float(ap50)}
    # int8 HBM: one calibration batch (its float forward runs K1), then
    # every batch on the HBM path: K1 for the float stem, Q1 for the 73
    # dense convs
    modes = (("bf16", ["--fp16"], lambda b: {"stem": b, "nms": b}),
             ("int8_hbm", ["--int8-hbm", "--calib-batches", "1"],
              lambda b: {"stem": b + 1, "nms": b, "int8_conv": 73 * b}))
    for key, flags, want in modes:
        runs(f"eval {key}", argv + flags, want(batches))
        res[key] = {"ap50_95": float(runs.evals[-1][0]),
                    "ap50": float(runs.evals[-1][1])}

    tb = -(-CLI_TIME_N // CLI_TIME_B)
    targv = ["eval", "-c", time_name, "--ckpt", ckpt, "-b", str(CLI_TIME_B)]
    tcfg = time_cls()

    def timing(wall=None):
        inside, part = runs.eval_s[-1], runs.parts[-1]
        out = {"img_per_s": CLI_TIME_N / inside, "eval_s": inside,
               "inference_s": part["inference_s"],
               "inference_img_per_s": part["timed_batches"] * CLI_TIME_B
               / part["inference_s"] if part["inference_s"] else None,
               "cocoeval_s": part["cocoeval_s"],
               "loader_and_rest_s": inside - part["inference_s"]
               - part["cocoeval_s"],
               "ap50_95": float(runs.evals[-1][0]),
               "ap50": float(runs.evals[-1][1])}
        if wall is not None:
            out.update(wall_s=wall, start_up_s=wall - inside)
        return out

    def reference(i):
        runs(f"config.eval f32 timed {i}", None, {"stem": tb, "nms": tb},
             call=lambda: tcfg.eval(module, tcfg.get_evaluator(CLI_TIME_B)),
             reference=True)
        return timing()

    timed = {"images": CLI_TIME_N, "batch": CLI_TIME_B,
             "workers": tcfg.data_num_workers,
             **eval_loader_rates(tcfg), "config_eval_1": reference(1)}
    for key, flags, want in (("f32", [], modes[0][2]),) + modes:
        runs(f"eval {key} timed", targv + flags, want(tb))
        timed[key] = timing(runs.runs[-1]["s"])
    timed["config_eval_2"] = reference(2)
    if timed["f32"]["ap50_95"] != timed["config_eval_1"]["ap50_95"]:
        raise AssertionError("the eval command's float32 AP differs from "
                             "config.eval on the timed set")
    res["timed"] = timed
    log("cli eval: " + json.dumps(res))
    del module
    return res


def cli_demo(runs, name, ckpt, cfg_cls, demo, clip, root):
    """`demo image` on the demo folder and `demo video` on the clip, each
    image and frame against `Yolox.__call__` (the same batches)."""
    import cv2
    from PIL import Image

    from yolox_tpu_torch import Yolox, YoloxModule, YoloxProcessor
    from yolox_tpu_torch.cli import demo as demo_cli
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = cfg_cls()
    module = YoloxModule.from_config(cfg, device=CARD)
    module.load_params(load_checkpoint(ckpt)["model"])
    model = Yolox(module, YoloxProcessor(cfg))

    def demo_run(argv):
        return demo_cli.run(demo_cli.make_parser().parse_args(argv))

    files = sorted(demo.iterdir())
    out = Path(root) / "demo_out"
    got = runs("demo image", None, {"stem": len(files), "nms": len(files)},
               call=lambda: demo_run([
                   "image", "-c", name, "--path", str(demo), "--ckpt", ckpt,
                   "--conf", str(CLI_CONF), "--save_result",
                   "--output-dir", str(out)]))
    want = [model([Image.open(f)], threshold=CLI_CONF)[0] for f in files]
    if got != want:
        raise AssertionError("demo image detections differ from "
                             "Yolox.__call__ on the same images")
    if sorted(p.name for p in out.iterdir()) != [f.name for f in files]:
        raise AssertionError("demo image did not save every image")
    n_img = sum(len(d["labels"]) for d in got)
    cap, frames = cv2.VideoCapture(clip), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame[:, :, ::-1]))
    cap.release()
    calls = -(-len(frames) // 2)
    got = runs("demo video", None, {"stem": calls, "nms": calls},
               call=lambda: demo_run([
                   "video", "-c", name, "--path", clip, "--ckpt", ckpt,
                   "--conf", str(CLI_CONF), "--batch", "2", "--save_result",
                   "--output-dir", str(out / "video")]))
    want = []
    for i in range(0, len(frames), 2):
        want += model(frames[i:i + 2], threshold=CLI_CONF)
    if len(frames) != CLI_VIDEO or got != want:
        raise AssertionError("demo video detections differ from "
                             "Yolox.__call__ on the same frames")
    cap = cv2.VideoCapture(str(out / "video" / Path(clip).name))
    written = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if written != CLI_VIDEO:
        raise AssertionError(f"demo video wrote {written} of {CLI_VIDEO} "
                             "frames")
    log(f"cli demo: {len(files)} images ({n_img} detections) and "
        f"{CLI_VIDEO} frames ({sum(len(d['labels']) for d in got)}) equal "
        "Yolox.__call__; every frame written")
    return module, {"image_detections": n_img,
                    "video_detections": sum(len(d["labels"]) for d in got)}


def _program_close(got, want, dets):
    """'bit-equal', or 'within phase 4 tolerances' (detections at
    `assert_dets_match`, raw outputs at rtol 1e-4 / atol 1e-2); raises
    otherwise."""
    import torch

    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return "bit-equal"
    if dets:
        assert_dets_match(got[0].cpu(), got[1].cpu(), want[0].cpu(),
                          want[1].cpu())
    elif not all(np.allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4,
                             atol=1e-2) for g, w in zip(got, want)):
        raise AssertionError("exported program against eager: beyond "
                             "rtol 1e-4 / atol 1e-2")
    return "within phase 4 tolerances"


def _wall_ms(fn, reps=CLI_TIME_REPS):
    """Median wall ms of fn() with the card synchronized, after 3 warm-up
    calls."""
    import torch

    samples = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 3:
            samples.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(samples))


def operator_cost(module):
    """Host µs a call of K1 and K2 (b1 serving shapes) and Q1 (a 3x3
    128->128 conv at 40 px, B 1) through the registered operator and
    through the wrapper's eager (direct) call: CLI_OP_CALLS calls each, the card
    synchronized around them (the calls are host-bound)."""
    import torch

    from yolox_tpu_torch.ops import int8_conv as q
    from yolox_tpu_torch.ops import nms_kernel, stem

    dev = module.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (1, 640, 640, 3), generator=gen, device=dev,
                      dtype=torch.uint8)
    scale, bias = module.backbone.backbone.stem.conv.bn_fold()
    wb = torch.randn(scale.shape[0], 3, 6, 6, generator=gen, device=dev)
    boxes = torch.rand(1, 256, 4, generator=gen, device=dev) * 300
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 256, dtype=torch.bool, device=dev)
    xq = torch.randint(-127, 128, (1, 128, 40, 40), generator=gen,
                       device=dev, dtype=torch.int8).contiguous(
                           memory_format=torch.channels_last)
    wq = q.pack_weight(torch.randint(-127, 128, (128, 128, 3, 3),
                                     generator=gen, device=dev,
                                     dtype=torch.int8))
    s8, b8 = torch.rand(128, device=dev) * 1e-3, torch.rand(128, device=dev)
    ops = torch.ops.yolox_tpu_torch
    cases = {
        "stem_conv_bn_act": (
            lambda: stem.stem_conv_bn_act(x, wb, scale, bias),
            lambda: ops.stem_conv_bn_act(x, wb, scale, bias, "silu",
                                         torch.float32)),
        "nms_keep": (lambda: nms_kernel.nms_keep(boxes, valid, 0.65),
                     lambda: ops.nms_keep(boxes, valid, 0.65)),
        "int8_conv": (
            lambda: q.int8_conv(xq, wq, s8, b8, 3, 1, "silu"),
            lambda: ops.int8_conv(xq, wq, s8, b8, 3, 1, "silu",
                                  torch.float32, None)),
    }
    out = {}
    for name, (direct, op) in cases.items():
        if not torch.equal(direct(), op()):
            raise AssertionError(f"{name}: the operator and the direct call "
                                 "disagree")
        us = {}
        for route, fn in (("direct", direct), ("op", op), ("direct2", direct),
                          ("op2", op)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CLI_OP_CALLS):
                fn()
            torch.cuda.synchronize()
            us[route] = 1e6 * (time.perf_counter() - t0) / CLI_OP_CALLS
        out[name] = {"direct_us": min(us["direct"], us["direct2"]),
                     "op_us": min(us["op"], us["op2"])}
        out[name]["op_cost_us"] = out[name]["op_us"] - out[name]["direct_us"]
    log("operator cost a call (host µs, min of two runs of "
        f"{CLI_OP_CALLS}): " + json.dumps(
            {k: {kk: round(vv, 2) for kk, vv in v.items()}
             for k, v in out.items()}))
    return out


def cli_export(runs, name, ckpt, module, demo, root):
    """`export` on the card: plain (B 1), `--include-postprocess` (B 1 and
    32) and `--int8` (B 1, calibrated on the demo images); each program
    reloaded with `torch.export.load` and run on the card with the
    counters read around the call, against the eager forward / serve /
    int8 ladder forward on the same input; exported against eager serve
    times at B 1 and 32; the operators' host cost."""
    import torch
    from PIL import Image

    from yolox_tpu_torch import YoloxProcessor
    from yolox_tpu_torch.cli.export import load_program
    from yolox_tpu_torch.ops.library import exported_ops

    gen = torch.Generator(device=CARD).manual_seed(3)
    res = {}
    calib = sorted(str(p) for p in demo.iterdir())
    table = module.calibrate_int8(YoloxProcessor(module.config)(
        [Image.open(p) for p in calib]))
    for kind, b, flags in (
            ("plain", 1, []),
            ("postprocess", 1, ["--include-postprocess", "--conf",
                                str(CLI_CONF)]),
            ("postprocess", 32, ["--include-postprocess", "--conf",
                                 str(CLI_CONF)]),
            ("int8", 1, ["--int8", "--calib-images"] + calib)):
        path = str(Path(root) / f"{kind}_b{b}.pt2")
        t0 = time.perf_counter()
        runs(f"export {kind} b{b}", ["export", "-c", name, "--ckpt", ckpt,
                                     "--batch-size", str(b), "--output",
                                     path] + flags)
        export_s = time.perf_counter() - t0
        loaded = load_program(path)
        nodes = {k: v for k, v in exported_ops(loaded).items() if v}
        program = loaded.module()
        x = torch.randint(0, 256, (b,) + tuple(module.config.test_size)
                          + (3,), generator=gen, device=CARD).float()
        with torch.inference_mode():
            if kind == "plain":
                def eager():
                    return (module(x),)
                want_launches = {"stem": 1}
            elif kind == "postprocess":
                def eager():
                    return module.serve(x, conf_thre=CLI_CONF,
                                        nms_thre=module.config.nmsthre)
                want_launches = {"stem": 1, "nms": 1}
            else:
                def eager():
                    return (module.forward_body(x, "ladder", table),)
                want_launches = {"int8_conv": 74}
            want = eager()

            def run_program():
                out = program(x)
                return out if isinstance(out, tuple) else (out,)

            got = runs(f"exported {kind} b{b}", None, want_launches,
                       call=run_program)
            held = _program_close(got, want, kind == "postprocess")
            entry = {"export_s": export_s, "held": held, "nodes": nodes}
            if kind == "postprocess":
                entry["exported_ms"] = _wall_ms(run_program)
                entry["eager_serve_ms"] = _wall_ms(eager)
                entry["exported_ms_2"] = _wall_ms(run_program)
                entry["eager_serve_ms_2"] = _wall_ms(eager)
        log(f"cli export {kind} b{b}: {held}, nodes {nodes}, "
            + json.dumps({k: v for k, v in entry.items()
                          if k.endswith("_ms") or k.endswith("_2")}))
        res[f"{kind}_b{b}"] = entry
    res["operator_cost"] = operator_cost(module)
    return res


def cli_train(runs, name, root):
    """`train` through the CLI: yolox-s, 640 px, B CLI_B, bf16,
    `fused_conv_bwd`, `device_augment`, 2 epochs of CLI_N / CLI_B
    iterations (epoch 1 augments on the card, epoch 2 letterboxes on the
    host), the counters read around every iteration and evaluation; then
    `eval --ckpt` on the checkpoint it wrote."""
    import math

    import yolox_tpu_torch

    recs = []
    cls = yolox_tpu_torch.YoloxConfig
    original = cls.get_trainer

    def get_trainer(cfg, args):
        trainer = original(cfg, args)
        recs.append(instrument_trainer(trainer, runs.counters))
        return trainer

    cls.get_trainer = get_trainer
    try:
        runs("train", ["train", "-c", name, "-b", str(CLI_B), "--fp16",
                       "-n", "train", "-D", "fused_conv_bwd=True",
                       "-D", "device_augment=True", "--seed", "0"])
    finally:
        cls.get_trainer = original
    rec, = recs
    # the trainer's hooks reset the counters around each iteration and
    # evaluation: the run's launches are theirs summed
    runs.runs[-1]["launches"] = {
        k: sum(r["launches"][k] for r in rec["iters"] + rec["evals"])
        for k in runs.counters}
    iters_per_epoch = CLI_N // CLI_B
    if len(rec["iters"]) != 2 * iters_per_epoch:
        raise AssertionError(f"train ran {len(rec['iters'])} iterations")
    for it in rec["iters"]:
        k5 = 1 if it["epoch"] == 0 else 0
        want = _only(runs.counters, reduce_sums=43, main_1x1=43,
                     shear_xy=k5)
        if it["launches"] != want or not math.isfinite(it["loss"]):
            raise AssertionError(f"train iteration {it['progress']}: "
                                 f"launches {it['launches']}, loss "
                                 f"{it['loss']}; want {want}, finite")
    batches = -(-CLI_N // CLI_B)
    for ev in rec["evals"]:
        if ev["launches"] != _only(runs.counters, stem=batches, nms=batches):
            raise AssertionError(f"train evaluation launched "
                                 f"{ev['launches']}")
    ckpt = Path(root) / "out" / "train" / "latest_ckpt.pth"
    if not ckpt.exists():
        raise AssertionError("train wrote no latest_ckpt.pth")
    runs("eval of the trained checkpoint",
         ["eval", "-c", name, "--ckpt", str(ckpt), "-b", str(CLI_B)],
         {"stem": batches, "nms": batches})
    log(f"cli train: {len(rec['iters'])} iterations, losses "
        + ", ".join(f"{it['loss']:.3f}" for it in rec["iters"])
        + f"; K3/K4 43 and K5 {[it['launches']['shear_xy'] for it in rec['iters']]}"
        " a step")
    return {"iters": [{k: it[k] for k in ("epoch", "ms", "loss",
                                          "device_augment", "launches")}
                      for it in rec["iters"]],
            "evals": rec["evals"]}


def cli_visualize(runs, name, root):
    """`visualize-assign` on the card and on the CPU: the same PNGs."""
    from PIL import Image

    outs = {}
    for dev in (CARD, "cpu"):
        out = Path(root) / f"assign_{dev}"
        runs(f"visualize-assign {dev}", ["visualize-assign", "-c", name,
                                         "-b", "2", "--output-dir", str(out),
                                         "--device", dev], {})
        outs[dev] = {p.name: np.asarray(Image.open(p))
                     for p in sorted(out.iterdir())}
    card, cpu = outs[CARD], outs["cpu"]
    if sorted(card) != sorted(cpu) or len(card) != 2:
        raise AssertionError(f"visualize-assign wrote {sorted(card)} on the "
                             f"card, {sorted(cpu)} on the CPU")
    differ = {k: int((card[k] != cpu[k]).any(-1).sum()) for k in card}
    log(f"cli visualize-assign: pixels that differ card vs CPU {differ}")
    if any(differ.values()):
        raise AssertionError("visualize-assign PNGs differ between the card "
                             "and the CPU")
    return {"pngs": sorted(card)}


def run_cli(cfg, rng, lines):
    """Phase 12: the `yolox-tpu-torch` commands on the card. Returns each
    kernel's launches summed over the phase's main-path runs."""
    import tempfile

    from yolox_tpu_torch import Yolox, YoloxModule, YoloxProcessor
    from yolox_tpu_torch.models.weights import save_pth_state_dict

    with tempfile.TemporaryDirectory() as root:
        module = spread_scores(
            YoloxModule.from_config(cfg, rng_seed=4321, device=CARD),
            np.random.default_rng(7).integers(0, 256, (2, 640, 640, 3),
                                              dtype=np.uint8))
        ckpt = str(Path(root) / "yolox_s_seed4321.pth")
        save_pth_state_dict(module.state_dict(), ckpt)
        demo, clip = cli_data(root, rng, Yolox(module, YoloxProcessor(cfg)))
        del module
        import cli_cfg

        name = "cli_cfg:CliConfig"
        runs = CliRuns()
        try:
            res = {"eval": cli_eval(runs, name, ckpt, cli_cfg.CliConfig,
                                    "cli_cfg:CliTimeConfig",
                                    cli_cfg.CliTimeConfig)}
            module, res["demo"] = cli_demo(runs, name, ckpt,
                                           cli_cfg.CliConfig, demo, clip,
                                           root)
            res["export"] = cli_export(runs, name, ckpt, module, demo, root)
            del module
            res["train"] = cli_train(runs, name, root)
            res["visualize_assign"] = cli_visualize(runs, name, root)
        finally:
            runs.close()
            sys.path.remove(root)
            sys.modules.pop("cli_cfg", None)
    totals = {k: sum(r["launches"][k] for r in runs.runs
                     if not r["reference"])
              for k in runs.counters}
    res["runs"] = runs.runs
    lines.append({"cli": res})
    return totals


# ------------------------------------------ data parallelism (phase 13)

PAR_WORLD = 2         # gloo ranks, both on the one card
PAR_B = 16            # the data-parallel step's global batch: 8 a rank
PAR_SIZE = 640
PAR_EVAL_B = CLI_TIME_B   # the evaluation's global batch: 16 a rank
PAR_TRAINER_B = 8     # the Trainer's global batch on the CLI set: 4 a rank
PAR_TRAINER_EPOCHS = 2
PAR_PREEMPT_AT = 0    # rank 1 sends itself SIGTERM after this iteration
PAR_TIME_REPS = 5     # timed steps (after 2 warm-up steps)
PAR_TIMEOUT_S = 600   # a collective waiting longer fails the phase
# the two-rank step against the mean of two one-process steps (one per
# half): each kind (momentum = gradient + weight decay after a first step,
# parameter update, BN running statistics) within PAR_TOL of its largest
# entry; float32 at phase 7's TRAIN_TOL, bf16 at one bf16 ulp (2^-8,
# phase 6's bf16 allowance for K4's weight gradient)
PAR_TOL = {"float32": TRAIN_TOL, "bfloat16": 2.0 ** -8}


def _zero(counters):
    _card_sync()
    for f in counters.values():
        f.launches = 0


def _count(counters):
    _card_sync()
    return {k: f.launches for k, f in counters.items()}


def _add(total, n):
    for k in total:
        total[k] += n[k]


def _halves(b=None):
    """Each rank's rows of a global batch of b (PAR_B)."""
    per = (b or PAR_B) // PAR_WORLD
    return [slice(r * per, (r + 1) * per) for r in range(PAR_WORLD)]


def _step_record(module, state, p0):
    """What one step left, on the CPU: the SGD momentum (the gradient plus
    weight decay after a first step), the parameter updates and the BN
    running statistics."""
    opt = state.optimizer
    params = dict(module.named_parameters())
    return {
        "momentum": {n: opt.state[p]["momentum_buffer"].detach().cpu()
                     for n, p in params.items()},
        "updates": {n: (p.detach() - p0[n]).cpu() for n, p in params.items()},
        "stats": {n: b.detach().cpu().clone()
                  for n, b in module.named_buffers()
                  if n.endswith(("running_mean", "running_var"))}}


def _held_step_record(cfg, card, dtype, x, labels, held, **kw):
    """One fused step from seeded yolox-s on a held assignment: (the
    record, losses, the launch counts of the step, the state)."""
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import init_train_state, make_train_step

    module = YoloxModule.from_config(cfg, rng_seed=4321, device=card)
    use_ema = kw.pop("use_ema", False)
    state = init_train_state(module, use_ema=use_ema)
    step = make_train_step(module, cfg.num_classes, use_ema=use_ema,
                           compute_dtype=dtype, fused_bwd=True, **kw)
    p0 = {n: p.detach().clone() for n, p in module.named_parameters()}
    counters = _launch_counters()
    _zero(counters)
    state, losses = step(state, x, labels, 0.01, assignment=held)
    n = _count(counters)
    return (_step_record(module, state, p0),
            {k: float(v) for k, v in losses.items()}, n, state)


def _want(n_convs, **more):
    want = {"reduce_sums": n_convs, "main_1x1": n_convs, "stem": 0,
            "nms": 0, "shear_x": 0, "shear_xy": 0, "int8_conv": 0,
            "int8_dwconv": 0}
    want.update(more)
    return want


def par_remat(cfg, card, x, labels, held, n_convs, totals):
    """`remat` against the plain step: the float32 B 16 fused step from
    seeded yolox-s on one held assignment, updates and momentum within
    TRAIN_TOL of their largest entry, BN statistics too, losses at
    TRAIN_LOSS_RTOL, every `num_batches_tracked` at 1; then each one's
    median ms over PAR_TIME_REPS steps and peak memory (as phase 7 times
    its steps)."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import init_train_state, make_train_step

    recs = {}
    for remat in (False, True):
        rec, losses, n, state = _held_step_record(
            cfg, card, torch.float32, x, labels, held, remat=remat)
        tracked = {int(b) for name, b in state.module.named_buffers()
                   if name.endswith("num_batches_tracked")}
        if n != _want(n_convs):
            raise AssertionError(f"the remat={remat} step launched {n}")
        if tracked != {1}:
            raise AssertionError(f"remat={remat}: num_batches_tracked "
                                 f"{tracked} after one step")
        if remat:
            _add(totals, n)
        recs[remat] = (rec, losses)
        del state
    ratios = {kind: tensors_close(recs[True][0][kind], recs[False][0][kind],
                                  TRAIN_TOL)
              for kind in ("momentum", "updates", "stats")}
    ratios["losses"] = _losses_close(recs[True][1], recs[False][1])
    log("remat against the plain step (float32, B 16, held assignment), "
        "share of tolerance: " + json.dumps(ratios))
    if max(ratios.values()) > 1:
        raise AssertionError("the remat step disagrees with the plain step")
    out = {"vs_plain_share_of_tol": ratios}
    for remat in (False, True):
        module = YoloxModule.from_config(cfg, rng_seed=4321, device=card)
        state = init_train_state(module)
        step = make_train_step(module, cfg.num_classes, fused_bwd=True,
                               remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        samples = _event_ms(lambda: step(state, x, labels, 0.01),
                            PAR_TIME_REPS)
        key = "remat" if remat else "plain"
        out[key] = {"median_ms": float(np.median(samples)),
                    "samples_ms": samples,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del module, state, step
    log("remat float32 B 16 fused step: " + json.dumps(
        {k: out[k] for k in ("plain", "remat")}))
    return out


def par_nccl(cfg, card, x, labels, held, n_convs, totals, root):
    """The float32 B 16 fused step through a process group of world size 1
    (NCCL on the card) against the same step with no group, from the same
    seeded model and held assignment, deterministic cuDNN: the same bits
    in parameters, buffers, momentum and EMA. A second plain step is held
    to the first the same way (the step itself is repeatable)."""
    import torch

    from yolox_tpu_torch.parallel import mesh

    backend = "nccl"
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh.init_distributed(backend, f"file://{root}/world1", 1, 0,
                          device=torch.device("cuda",
                                              torch.cuda.current_device()),
                          timeout=PAR_TIMEOUT_S)
    try:
        states = {}
        for name in ("plain", "plain_again", backend):
            group = torch.distributed.group.WORLD if name == backend else None
            _, _, n, state = _held_step_record(
                cfg, card, torch.float32, x, labels, held, use_ema=True,
                group=group)
            if n != _want(n_convs):
                raise AssertionError(f"the {name} step launched {n}")
            if name == backend:
                _add(totals, n)
            states[name] = mesh.state_bytes(state)
            del state
    finally:
        mesh.destroy_distributed()
        torch.backends.cudnn.deterministic = saved
    out = {"backend": backend,
           "plain_repeat_bit_equal": torch.equal(states["plain"],
                                                 states["plain_again"]),
           "bit_equal": torch.equal(states["plain"], states[backend]),
           "state_bytes": int(states["plain"].numel())}
    log(f"{backend} at world size 1 against one process: " + json.dumps(out))
    if not (out["bit_equal"] and out["plain_repeat_bit_equal"]):
        raise AssertionError(f"the {backend} world-1 step is not the "
                             "one-process step bit for bit")
    return out


def par_oracle(cfg, card, x, labels, held, dtype):
    """Two one-process steps on the card, one on each half of the batch
    from the seeded model with that half's held assignment: the mean of
    their records and of their losses."""
    recs, losses = [], []
    for r, half in enumerate(_halves()):
        rec, loss, _, state = _held_step_record(
            cfg, card, dtype, x[half], labels[half], held[r])
        recs.append(rec)
        losses.append(loss)
        del state
    mean = {kind: {k: (recs[0][kind][k] + recs[1][kind][k]) / 2
                   for k in recs[0][kind]} for kind in recs[0]}
    return mean, {k: (losses[0][k] + losses[1][k]) / 2 for k in losses[0]}


def par_eval_one_process(card, ckpt, n_images):
    """The one-process evaluations of the timed CLI set (`cli_cfg` on the
    path): at the ranks' batch (PAR_EVAL_B / PAR_WORLD, the same batches
    the ranks take: the statistics a two-rank run must equal) and, timed,
    at PAR_EVAL_B."""
    import cli_cfg
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    tcfg = cli_cfg.CliTimeConfig()
    module = YoloxModule.from_config(tcfg, device=card)
    module.load_params(load_checkpoint(ckpt)["model"])
    ev = tcfg.get_evaluator(PAR_EVAL_B // PAR_WORLD)
    tcfg.eval(module, ev)
    stats = np.asarray(ev.stats)
    ev32 = tcfg.get_evaluator(PAR_EVAL_B)
    _card_sync()
    t0 = time.perf_counter()
    tcfg.eval(module, ev32)
    _card_sync()
    wall = time.perf_counter() - t0
    del module
    torch.cuda.empty_cache()
    return stats, {"img_per_s": n_images / wall, "wall_s": wall,
                   "stats_b32": [float(s) for s in ev32.stats]}


# ---- what each rank runs (spawned; `card` is the one device of both)

def par_rank_steps(rank, inp, card, root):
    """The data-parallel step on this rank's half with its held
    assignment, float32 and bf16: launches, the rank-mean losses, whether
    the ranks hold the same bytes after it; rank 0 saves its record."""
    import torch

    from yolox_tpu_torch.parallel.mesh import ranks_identical

    half = _halves(len(inp["x"]))[rank]
    x, labels = inp["x"][half].to(card), inp["labels"][half].to(card)
    held = {k: v.to(card) for k, v in inp["held"][rank].items()}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        rec, losses, n, state = _held_step_record(
            inp["cfg"], card, dtype, x, labels, held, use_ema=True,
            group=torch.distributed.group.WORLD)
        out[name] = {"launches": n, "losses": losses,
                     "identical": ranks_identical(state)}
        if rank == 0:
            torch.save(rec, Path(root) / f"dp_{name}.pt")
        del state
    return out


def par_rank_times(rank, inp, card):
    """This rank's step ms (PAR_TIME_REPS after 2 warm-up steps, both
    ranks stepping together on the card), then the all-reduce's ms inside
    3 more steps (synchronised around it), float32 and bf16."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import init_train_state, make_train_step
    from yolox_tpu_torch.parallel.mesh import MeanReducer

    half = _halves(len(inp["x"]))[rank]
    x, labels = inp["x"][half].to(card), inp["labels"][half].to(card)
    cfg, out = inp["cfg"], {}
    for dtype in (torch.float32, torch.bfloat16):
        module = YoloxModule.from_config(cfg, rng_seed=4321, device=card)
        state = init_train_state(module)
        step = make_train_step(module, cfg.num_classes, compute_dtype=dtype,
                               fused_bwd=True,
                               group=torch.distributed.group.WORLD)
        torch.distributed.barrier()
        samples = _event_ms(lambda: step(state, x, labels, 0.01),
                            PAR_TIME_REPS)
        reduce_ms, sizes = [], []
        orig = MeanReducer.__call__

        def timed(self, tensors):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(self, tensors)
            torch.cuda.synchronize()
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
            sizes.append(sum(t.numel() for t in tensors))

        MeanReducer.__call__ = timed
        try:
            for _ in range(3):
                step(state, x, labels, 0.01)
        finally:
            MeanReducer.__call__ = orig
        out[str(dtype).split(".")[-1]] = {
            "median_ms": float(np.median(samples)), "samples_ms": samples,
            "allreduce_ms": reduce_ms, "allreduce_values": sizes[0]}
        del module, state, step
    return out


def par_rank_augment(rank, inp, card):
    """3 `make_augmented_train_step` iterations (bf16, fused) on this
    rank's tiles from this rank's generator (seeded as the Trainer seeds
    it, `augment_seed`): launches, the batch the step augmented against
    the same seed's batch made again (outside the counted window), the
    ranks' batch sums, the ranks' states after each step."""
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.core import (
        init_train_state,
        make_augmented_train_step,
    )
    from yolox_tpu_torch.core import train_step as ts
    from yolox_tpu_torch.core.trainer import augment_seed
    from yolox_tpu_torch.parallel.mesh import (
        all_gather_objects,
        ranks_identical,
    )

    half = _halves(len(inp["x"]))[rank]
    args = [inp[k][half].to(card) for k in ("tiles", "hw", "tile_labels")]
    size = tuple(inp["tiles"].shape[2:4])
    cfg = inp["cfg"]
    module = YoloxModule.from_config(cfg, rng_seed=4321, device=card)
    state = init_train_state(module)
    step = make_augmented_train_step(
        module, cfg.num_classes, compute_dtype=torch.bfloat16,
        fused_bwd=True, group=torch.distributed.group.WORLD)
    gen = torch.Generator(device=card)
    counters = _launch_counters()
    calls, orig = [], ts.device_augment_batch

    def recording(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    ts.device_augment_batch = recording
    recs = []
    try:
        for i in range(3):
            seed = augment_seed(0, rank, i)
            gen.manual_seed(seed)
            _zero(counters)
            state, losses = step(state, *args, gen, 0.01, size)
            n = _count(counters)
            a, kw, (imgs, packed) = calls[-1]
            gen.manual_seed(seed)
            again = orig(*a[:3], gen, **kw)
            recs.append({
                "launches": n,
                "losses": {k: float(v) for k, v in losses.items()},
                "deterministic": torch.equal(again[0], imgs)
                and torch.equal(again[1], packed),
                "batch_sums": all_gather_objects(float(imgs.float().sum())),
                "identical": ranks_identical(state)})
    finally:
        ts.device_augment_batch = orig
    return recs


def par_rank_eval(rank, inp, card):
    """The two-rank evaluation of the timed CLI set at PAR_EVAL_B (each
    rank its batches of PAR_EVAL_B / PAR_WORLD): launches, rank 0's
    statistics, every rank's wall seconds (both start at a barrier, the
    model warmed by one forward at the rank's batch)."""
    import cli_cfg
    import torch

    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.parallel.mesh import all_gather_objects
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    tcfg = cli_cfg.CliTimeConfig()
    module = YoloxModule.from_config(tcfg, device=card)
    module.load_params(load_checkpoint(inp["ckpt"])["model"])
    evaluator = tcfg.get_evaluator(PAR_EVAL_B, is_distributed=True)
    module(np.zeros((PAR_EVAL_B // PAR_WORLD,) + tuple(tcfg.test_size)
                    + (3,), np.float32))
    counters = _launch_counters()
    torch.distributed.barrier()
    _zero(counters)
    t0 = time.perf_counter()
    ap, ap50, _ = tcfg.eval(module, evaluator, True)
    _card_sync()
    wall = time.perf_counter() - t0
    n = _count(counters)
    return {"launches": n, "batches": len(evaluator.dataloader),
            "ap": (float(ap), float(ap50)),
            "stats": None if evaluator.stats is None
            else [float(s) for s in evaluator.stats],
            "wall_s": all_gather_objects(wall)}


def par_rank_trainer(rank, inp, card, root):
    """`Trainer` on the CLI set (yolox-s, 640 px, bf16, `fused_conv_bwd`,
    `device_augment`, global B PAR_TRAINER_B): (a) PAR_TRAINER_EPOCHS
    epochs with an evaluation after each; (b) a long run that rank 1 sends
    SIGTERM to itself after iteration PAR_PREEMPT_AT. Per rank: each
    iteration's and evaluation's launches, LR and loss, the iteration each
    rank left at, and which checkpoints this rank wrote."""
    import signal
    from argparse import Namespace

    import cli_cfg

    from yolox_tpu_torch.core import trainer as tr
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    counters = _launch_counters()
    writes, save = [], tr.save_checkpoint

    def recording(state, is_best, save_dir, name=""):
        writes.append(name)
        return save(state, is_best, save_dir, name)

    tr.save_checkpoint = recording
    out = {}
    try:
        for name, epochs in (("par", PAR_TRAINER_EPOCHS),
                             ("par_preempt", 100)):
            tcfg = cli_cfg.CliConfig()
            tcfg.max_epoch, tcfg.fused_conv_bwd = epochs, True
            tcfg.device_augment = True
            tcfg.output_dir = str(Path(root) / "trainer")
            args = Namespace(batch_size=PAR_TRAINER_B, fp16=True,
                             cache=None, logger="tensorboard", ckpt=None,
                             resume=False, start_epoch=None, name=name,
                             device=card)
            trainer = tcfg.get_trainer(args)
            rec = instrument_trainer(trainer, counters)
            exits = []
            if name == "par_preempt":
                after, handle = trainer.after_iter, \
                    trainer._maybe_handle_preemption

                def after_iter():
                    after()
                    if rank == 1 and trainer.progress_in_iter == \
                            PAR_PREEMPT_AT:
                        os.kill(os.getpid(), signal.SIGTERM)

                def handled():
                    try:
                        handle()
                    except tr.PreemptionExit:
                        exits.append(trainer.progress_in_iter)
                        raise

                trainer.after_iter = after_iter
                trainer._maybe_handle_preemption = handled
            n0 = len(writes)
            t0 = time.perf_counter()
            trainer.train()
            res = {"wall_s": time.perf_counter() - t0,
                   "max_iter": trainer.max_iter, "exits": exits,
                   "writes": writes[n0:], "evals": rec["evals"],
                   "iters": [{k: it[k] for k in ("progress", "epoch", "lr",
                                                 "loss", "launches", "ms",
                                                 "device_augment")}
                             for it in rec["iters"]]}
            if name == "par":
                sched = trainer.exp.get_lr_scheduler(
                    trainer.exp.basic_lr_per_img * PAR_TRAINER_B,
                    trainer.max_iter)
                res["lr_on_schedule"] = all(
                    it["lr"] == sched.update_lr(it["progress"] + 1)
                    for it in rec["iters"])
            latest = Path(trainer.file_name) / "latest_ckpt.pth"
            if rank == 0 and name == "par_preempt":
                res["resume_start_epoch"] = load_checkpoint(
                    str(latest))["start_epoch"]
            out[name] = res
            del trainer
    finally:
        tr.save_checkpoint = save
    return out


def parallel_rank(rank, root, card):
    """One of phase 13's PAR_WORLD gloo ranks, all on `card`: the
    data-parallel step, its times, the augmented step, the evaluation and
    the Trainer; what it saw goes to `root/rank<r>.pt`."""
    import torch

    from yolox_tpu_torch.parallel import mesh

    global CARD
    CARD = card  # this process's phases (`instrument_trainer`) run there
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(Path(root) / "inputs.pt", weights_only=False)
    sys.path.insert(0, inp["cli_root"])
    mesh.init_distributed("gloo", f"file://{root}/rendezvous", PAR_WORLD,
                          rank, device="cuda:0", timeout=PAR_TIMEOUT_S)
    out = {"rank": rank}
    try:
        out["steps"] = par_rank_steps(rank, inp, card, root)
        out["times"] = par_rank_times(rank, inp, card)
        out["augment"] = par_rank_augment(rank, inp, card)
        out["eval"] = par_rank_eval(rank, inp, card)
        out["trainer"] = par_rank_trainer(rank, inp, card, root)
    finally:
        mesh.destroy_distributed()
    torch.save(out, Path(root) / f"rank{rank}.pt")


# ---- phase 13 in the parent: the oracles, then the ranks, then the checks

def par_check_steps(ranks, oracles, root, n_convs):
    import torch

    out = {}
    for name, (mean, mean_losses) in oracles.items():
        got = torch.load(Path(root) / f"dp_{name}.pt")
        ratios = {kind: tensors_close(got[kind], mean[kind], PAR_TOL[name])
                  for kind in ("momentum", "updates", "stats")}
        recs = [r["steps"][name] for r in ranks]
        ratios["losses"] = _losses_close(recs[0]["losses"], mean_losses)
        out[name] = {"share_of_tol": ratios,
                     "identical": [r["identical"] for r in recs],
                     "losses": recs[0]["losses"]}
        log(f"two-rank {name} step against the mean of two one-process "
            f"steps: " + json.dumps(out[name]))
        if max(ratios.values()) > 1:
            raise AssertionError(f"the two-rank {name} step is not the mean "
                                 "of the one-process steps")
        if not all(out[name]["identical"]) or \
                recs[0]["losses"] != recs[1]["losses"]:
            raise AssertionError(f"the ranks differ after the {name} step")
        for r in recs:
            if r["launches"] != _want(n_convs):
                raise AssertionError(f"a two-rank step launched "
                                     f"{r['launches']}")
    return out


def par_check_augment(ranks, n_convs):
    for r in ranks:
        for i, it in enumerate(r["augment"]):
            if it["launches"] != _want(n_convs, shear_xy=1):
                raise AssertionError(f"rank {r['rank']} augmented step {i} "
                                     f"launched {it['launches']}")
            if not (it["deterministic"] and it["identical"]):
                raise AssertionError(f"rank {r['rank']} augmented step {i}: "
                                     f"{it}")
            if len(set(it["batch_sums"])) != PAR_WORLD:
                raise AssertionError("two ranks augmented the same batch")
            if not all(np.isfinite(v) for v in it["losses"].values()):
                raise AssertionError("an augmented step's loss is not finite")
    out = [it["losses"]["total_loss"] for it in ranks[0]["augment"]]
    log(f"two-rank augmented steps: deterministic under each rank's seed, "
        f"ranks identical after each, total losses {out}")
    return out


def par_check_eval(ranks, stats_one, n_batches):
    r0, r1 = ranks[0]["eval"], ranks[1]["eval"]
    if r1["ap"] != (0.0, 0.0) or r1["stats"] is not None:
        raise AssertionError(f"rank 1's evaluation returned {r1['ap']}")
    if not np.array_equal(np.asarray(r0["stats"]), stats_one):
        raise AssertionError(f"two-rank statistics {r0['stats']} differ from "
                             f"one process's {list(stats_one)}")
    for r in ranks:
        b = r["eval"]["batches"]
        if r["eval"]["launches"] != _want(0, stem=b, nms=b):
            raise AssertionError(f"rank {r['rank']} evaluation launched "
                                 f"{r['eval']['launches']}")
    if sum(r["eval"]["batches"] for r in ranks) != n_batches:
        raise AssertionError("the ranks did not share the batches")
    log(f"two-rank evaluation: the 12 statistics equal one process's at the "
        f"same batches; AP50:95 {r0['ap'][0]!r}")


def par_check_trainer(ranks, n_convs, eval_batches):
    for r in ranks:
        a = r["trainer"]["par"]
        if len(a["iters"]) != a["max_iter"] * PAR_TRAINER_EPOCHS or \
                not a["lr_on_schedule"]:
            raise AssertionError(f"rank {r['rank']} ran {len(a['iters'])} "
                                 f"iterations, LR on the schedule: "
                                 f"{a['lr_on_schedule']}")
        for it in a["iters"]:
            k5 = int(it["device_augment"])
            if it["launches"] != _want(n_convs, shear_xy=k5) or \
                    not np.isfinite(it["loss"]):
                raise AssertionError(f"rank {r['rank']} trainer iteration "
                                     f"{it}")
        for ev in a["evals"]:
            b = eval_batches[r["rank"]]
            if ev["launches"] != _want(0, stem=b, nms=b):
                raise AssertionError(f"rank {r['rank']} trainer evaluation "
                                     f"launched {ev['launches']}")
        p = r["trainer"]["par_preempt"]
        if p["exits"] != [PAR_PREEMPT_AT]:
            raise AssertionError(f"rank {r['rank']} left the preempted run "
                                 f"at {p['exits']}, not {PAR_PREEMPT_AT}")
    a0, a1 = (r["trainer"]["par"] for r in ranks)
    if not a0["writes"] or a1["writes"]:
        raise AssertionError(f"checkpoints written by rank 0: {a0['writes']},"
                             f" rank 1: {a1['writes']}")
    p0, p1 = (r["trainer"]["par_preempt"] for r in ranks)
    if p0["writes"] != ["latest"] or p1["writes"] or \
            p0["resume_start_epoch"] != 0:
        raise AssertionError(f"the preempted run wrote {p0['writes']} / "
                             f"{p1['writes']}, resume epoch "
                             f"{p0.get('resume_start_epoch')}")
    if [it["loss"] for it in a0["iters"]] != \
            [it["loss"] for it in a1["iters"]]:
        raise AssertionError("the ranks logged different losses")
    log(f"two-rank Trainer: {len(a0['iters'])} iterations a rank, "
        f"{len(a0['evals'])} evaluations, checkpoints {a0['writes']} by rank "
        f"0 only; SIGTERM to rank 1 after iteration {PAR_PREEMPT_AT}: both "
        f"left there, rank 0 wrote {p0['writes']} (resume at epoch "
        f"{p0['resume_start_epoch']})")
    return {"par_wall_s": [r["trainer"]["par"]["wall_s"] for r in ranks],
            "median_iter_ms": [float(np.median(
                [it["ms"] for it in r["trainer"]["par"]["iters"][1:]]))
                for r in ranks],
            "losses": [it["loss"] for it in a0["iters"]],
            "checkpoints": a0["writes"],
            "preempt": {"exits": [r["trainer"]["par_preempt"]["exits"]
                                  for r in ranks],
                        "writes": p0["writes"]}}


def _rank_launches(r):
    """A rank's launches over its main-path runs."""
    total = dict.fromkeys(_launch_counters(), 0)
    for name in r["steps"]:
        _add(total, r["steps"][name]["launches"])
    for it in r["augment"]:
        _add(total, it["launches"])
    _add(total, r["eval"]["launches"])
    for run in r["trainer"].values():
        for it in run["iters"] + run["evals"]:
            _add(total, it["launches"])
    return total


def run_parallel(cfg, rng, n_convs, lines):
    """Phase 13: data parallelism on the card. Returns each kernel's
    launches summed over the phase's main-path runs (both ranks)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from yolox_tpu_torch import Yolox, YoloxModule, YoloxProcessor
    from yolox_tpu_torch.models.weights import save_pth_state_dict

    t_phase = time.perf_counter()
    card = CARD
    if torch.device(card).type != "cuda":
        raise RuntimeError(f"phase 13 runs its ranks on a CUDA device, not "
                           f"{card}: its launch counts come from the kernels")
    totals = dict.fromkeys(_launch_counters(), 0)
    x = rng.uniform(0, 255, (PAR_B, PAR_SIZE, PAR_SIZE, 3)).astype(np.float32)
    labels = synthetic_labels(rng, PAR_B, PAR_SIZE)
    tiles, hw, tile_labels = synthetic_tiles(rng, PAR_B, PAR_SIZE)
    xg, lg = torch.from_numpy(x).to(card), torch.from_numpy(labels).to(card)
    base = YoloxModule.from_config(cfg, rng_seed=4321, device=card)
    held = [_assignment(base, xg[h], lg[h], cfg.num_classes)
            for h in _halves()]
    full = _assignment(base, xg, lg, cfg.num_classes)
    del base
    res = {"card": nvidia_smi(), "world": PAR_WORLD, "batch": PAR_B, "size": PAR_SIZE}
    res["remat"] = par_remat(cfg, card, xg, lg, full, n_convs, totals)
    with tempfile.TemporaryDirectory() as root:
        res["world_size_1"] = par_nccl(cfg, card, xg, lg, full, n_convs,
                                       totals, root)
        oracles = {str(dt).split(".")[-1]: par_oracle(cfg, card, xg, lg,
                                                      held, dt)
                   for dt in (torch.float32, torch.bfloat16)}
        cli_root = Path(root) / "cli"
        cli_root.mkdir()
        module = spread_scores(
            YoloxModule.from_config(cfg, rng_seed=4321, device=card),
            np.random.default_rng(7).integers(0, 256, (2, 640, 640, 3),
                                              dtype=np.uint8))
        ckpt = str(cli_root / "yolox_s_seed4321.pth")
        save_pth_state_dict(module.state_dict(), ckpt)
        cli_data(str(cli_root), rng, Yolox(module, YoloxProcessor(cfg)))
        del module
        try:
            stats_one, res["eval_one_process"] = par_eval_one_process(
                card, ckpt, CLI_TIME_N)
            torch.save({"cfg": cfg, "x": torch.from_numpy(x),
                        "labels": torch.from_numpy(labels),
                        "held": [{k: v.cpu() for k, v in h.items()}
                                 for h in held],
                        "tiles": torch.from_numpy(tiles),
                        "hw": torch.from_numpy(hw),
                        "tile_labels": torch.from_numpy(tile_labels),
                        "cli_root": str(cli_root), "ckpt": ckpt},
                       Path(root) / "inputs.pt")
            del xg, lg
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            mp.spawn(parallel_rank, args=(root, card), nprocs=PAR_WORLD,
                     join=True)
            res["ranks_s"] = time.perf_counter() - t0
            ranks = [torch.load(Path(root) / f"rank{r}.pt",
                                weights_only=False)
                     for r in range(PAR_WORLD)]
            res["steps"] = par_check_steps(ranks, oracles, root, n_convs)
        finally:
            sys.path.remove(str(cli_root))
            sys.modules.pop("cli_cfg", None)
    res["step_times"] = [r["times"] for r in ranks]
    res["augment_losses"] = par_check_augment(ranks, n_convs)
    n_batches = -(-CLI_TIME_N // (PAR_EVAL_B // PAR_WORLD))
    par_check_eval(ranks, stats_one, n_batches)
    res["eval_two_ranks"] = {
        "img_per_s": CLI_TIME_N / max(ranks[0]["eval"]["wall_s"]),
        "wall_s": ranks[0]["eval"]["wall_s"],
        "stats": ranks[0]["eval"]["stats"]}
    per_rank = PAR_TRAINER_B // PAR_WORLD
    eval_batches = [len(range(r, -(-CLI_N // per_rank), PAR_WORLD))
                    for r in range(PAR_WORLD)]
    res["trainer"] = par_check_trainer(ranks, n_convs, eval_batches)
    for r in ranks:
        _add(totals, _rank_launches(r))
    res["launches"] = totals
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 13 (parallel) wall: {res['wall_s']:.1f} s")
    lines.append({"parallel": res})
    return totals


# ------------------------------------------- serving meshes (phase 14)

MESH_WORLD = 4        # gloo ranks, all on the one card
MESH_MAX_DET = 256
MESH_TIME_REPS = 20   # timed b1 calls a rank, after MESH_WARMUP
MESH_WARMUP = 3
MESH_TIMEOUT_S = 300  # a collective waiting longer fails the phase
MESH_SEEDS = {"yolox_s": 4321, "yolov3": 777, "yolox_nano": 1234}
# (name, model, dtype, (n_data, n_space), batch, px, int8 mode)
MESH_CASES = (
    ("s_f32_1x2_b1", "yolox_s", "float32", (1, 2), 1, 640, None),
    ("s_f32_2x1_b2", "yolox_s", "float32", (2, 1), 2, 640, None),
    ("s_bf16_1x2_b1", "yolox_s", "bfloat16", (1, 2), 1, 640, None),
    ("s_bf16_2x1_b2", "yolox_s", "bfloat16", (2, 1), 2, 640, None),
    ("s_bf16_2x2_b2", "yolox_s", "bfloat16", (2, 2), 2, 640, None),
    ("s_hbm_1x2_b1", "yolox_s", "bfloat16", (1, 2), 1, 640, "hbm"),
    ("s_ladder_1x2_b1", "yolox_s", "bfloat16", (1, 2), 1, 640, "ladder"),
    ("v3_f32_1x2_b1", "yolov3", "float32", (1, 2), 1, 640, None),
    ("nano_hbm_1x2_416", "yolox_nano", "float32", (1, 2), 1, 416, "hbm"),
    ("nano_f32_1x4_96", "yolox_nano", "float32", (1, 4), 1, 96, None),
)
MESH_TIMED = ("s_f32_1x2_b1", "s_bf16_1x2_b1")


def mesh_module(model, dtype, card, preds=None):
    """Seeded `model` (`MESH_SEEDS`) on `card` in `dtype`, its prediction
    convs set to `preds` (the parent's spread scores) when given."""
    import torch

    from yolox_tpu_torch import YoloxConfig, YoloxModule

    module = YoloxModule.from_config(YoloxConfig.get_named_config(model),
                                     rng_seed=MESH_SEEDS[model], device=card)
    if preds is not None:
        module.load_params(preds, strict=False)
    return module.cast_params(getattr(torch, dtype))


def mesh_threshold(scores):
    """A threshold in a gap of the anchors' `scores` (B, A) that keeps
    several times `INT8_MIN_DETS` candidates an image: between the
    4 * INT8_MIN_DETS-th and 12 * INT8_MIN_DETS-th highest scores of the
    batch, per image. Returns (threshold, relative gap)."""
    s = np.sort(scores.ravel())[::-1]
    b = scores.shape[0]
    hi, lo = (s[min(len(s) - 1, n * INT8_MIN_DETS * b)] for n in (4, 12))
    return gap_threshold(scores, lo, hi)


def mesh_kwargs(thr, mode, table):
    kw = {"conf_thre": thr, "max_det": MESH_MAX_DET}
    if mode is not None:
        kw["int8_qtab" if mode == "ladder" else "int8_hbm_qtab"] = table
    return kw


def _has_rows(size, shape, coords):
    from yolox_tpu_torch.parallel.halo import row_slabs

    a, b = row_slabs(size, shape[1])[coords[1]]
    return b > a


def _wall_call_ms(fn):
    _card_sync()
    t0 = time.perf_counter()
    fn()
    _card_sync()
    return 1e3 * (time.perf_counter() - t0)


def mesh_times(fn, module, x, kw, reps):
    """Median wall ms of the meshed call and of one-process `serve` on this
    rank (both ranks of the mesh run theirs at once on the one card), and
    the meshed call's exchanges: counts and bytes, and the median of
    their host ms."""
    for _ in range(MESH_WARMUP):
        fn(x)
        module.serve(x, **kw)
    meshed, exch = [], []
    for _ in range(reps):
        meshed.append(_wall_call_ms(lambda: fn(x)))
        exch.append(1e3 * fn.stats["space"]["exchange_s"])
    one = [_wall_call_ms(lambda: module.serve(x, **kw)) for _ in range(reps)]
    st = fn.stats["space"]
    return {"meshed_ms": float(np.median(meshed)),
            "one_process_ms": float(np.median(one)),
            "exchanges": st["exchanges"], "exchange_bytes": st["exchange_bytes"],
            "exchange_ms": float(np.median(exch)),
            "gather_bytes": st["gather_bytes"]}


def mesh_rank(rank, root, cards, backend):
    """One of len(`cards`) ranks of a `backend` group, on `cards[rank]`
    (phase 14: MESH_WORLD gloo ranks, all on the one card): every case of
    `mesh_inputs.pt` through `make_serving_fn(mesh=...)` (each mesh made
    on every rank, served on its members): one warm-up call, one call with
    the launch counters read around it, and for the timed cases
    `mesh_times`; what it saw goes to `root/mesh_rank<r>.pt`."""
    import torch

    from yolox_tpu_torch.parallel import mesh as pm

    global CARD
    card = CARD = cards[rank]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(Path(root) / "mesh_inputs.pt", weights_only=False)
    device = torch.device(card)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    pm.init_distributed(backend, f"file://{root}/mesh_rendezvous",
                        len(cards), rank, device=device,
                        timeout=MESH_TIMEOUT_S)
    counters = _launch_counters()
    out = {"rank": rank, "cases": {}, "times": {}}
    modules = {}
    try:
        for name, model, dtype, shape, _, _, _ in inp["cases"]:
            mesh = pm.serving_mesh(*shape)
            if mesh.coords is None:
                continue
            if (model, dtype) not in modules:
                modules[(model, dtype)] = mesh_module(
                    model, dtype, card, inp["preds"][model])
            module = modules[(model, dtype)]
            x, kw = inp["x"][name], inp["kwargs"][name]
            fn = module.make_serving_fn(mesh=mesh, **kw)
            fn(x)
            _zero(counters)
            dets, valid = fn(x)
            launches = _count(counters)
            out["cases"][name] = {"dets": dets.cpu(), "valid": valid.cpu(),
                                  "launches": launches,
                                  "coords": mesh.coords, "stats": fn.stats}
            if name in inp["timed"]:
                out["times"][name] = mesh_times(fn, module, x, kw,
                                                inp["time_reps"])
    finally:
        pm.destroy_distributed()
    torch.save(out, Path(root) / f"mesh_rank{rank}.pt")


def mesh_inputs(rng, card, cases=MESH_CASES, timed=MESH_TIMED):
    """The parent's part before the ranks: each case's uint8 batch, seeded
    models with spread scores, the int8 tables calibrated here, thresholds
    in a gap of each case's own scores, and each case's one-process
    `serve` on the card with its launch counts: (inputs for the ranks,
    references, the modules)."""
    import torch

    counters = _launch_counters()
    frames, nb = {}, max([2] + [c[4] for c in cases])
    for name, model, _, _, b, px, _ in cases:
        frames.setdefault((model, px), rng.integers(
            0, 256, (nb, px, px, 3), dtype=np.uint8))
    preds, modules = {}, {}
    for name, model, dtype, shape, b, px, mode in cases:
        if model not in preds:
            m = spread_scores(mesh_module(model, "float32", card),
                              frames[(model, px)])
            preds[model] = {k: v.cpu() for k, v in m.state_dict().items()
                            if "_preds." in k}
        if (model, dtype) not in modules:
            modules[(model, dtype)] = mesh_module(model, dtype, card,
                                                  preds[model])
    tables, inp, refs = {}, {"x": {}, "kwargs": {}}, {}
    for name, model, dtype, shape, b, px, mode in cases:
        module = modules[(model, dtype)]
        x = frames[(model, px)][:b]
        table = None
        if mode is not None:  # on the host: the ranks read it from there
            if (model, dtype) not in tables:
                tables[(model, dtype)] = {
                    k: v.cpu() for k, v in module.calibrate_int8(
                        frames[(model, px)]).items()}
            table = tables[(model, dtype)]
        with torch.inference_mode():
            out = module.forward_body(x, mode, table).float()
        scores = (out[..., 4] * out[..., 5:].amax(-1)).cpu().numpy()
        thr, gap = mesh_threshold(scores)
        kw = mesh_kwargs(thr, mode, table)
        # at the ranks' own batch: each `data` share served alone
        share = b // shape[0]
        parts = [x[i:i + share] for i in range(0, b, share)]
        module.serve(parts[0], **kw)
        _zero(counters)
        got = [module.serve(part, **kw) for part in parts[:1]]
        launches = _count(counters)
        got += [module.serve(part, **kw) for part in parts[1:]]
        dets, valid = (torch.cat(t).cpu().numpy() for t in zip(*got))
        if valid.sum(1).min() < INT8_MIN_DETS:
            raise AssertionError(f"{name}: {valid.sum(1).tolist()} "
                                 f"detections at {thr:.4f}")
        refs[name] = {"dets": dets, "valid": valid, "launches": launches,
                      "thr": thr, "gap": gap}
        if shape[0] > 1:  # and one call on the whole batch
            refs[name]["batch"] = tuple(t.cpu().numpy()
                                        for t in module.serve(x, **kw))
        inp["x"][name], inp["kwargs"][name] = x, kw
    inp.update(cases=cases, preds=preds, timed=timed,
               time_reps=MESH_TIME_REPS)
    return inp, refs, modules


def mesh_nccl(module, x, kw, root):
    """The (1, 1) mesh through an NCCL process group of world size 1,
    deterministic cuDNN: the same bits as `serve`, with the launch counts
    read around it (its data gather goes through NCCL)."""
    import torch

    from yolox_tpu_torch.parallel import mesh as pm

    counters = _launch_counters()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pm.init_distributed("nccl", f"file://{root}/mesh_world1", 1, 0,
                        device=torch.device("cuda",
                                            torch.cuda.current_device()),
                        timeout=MESH_TIMEOUT_S)
    try:
        fn = module.make_serving_fn(mesh=pm.serving_mesh(1, 1), **kw)
        want = module.serve(x, **kw)
        fn(x)
        _zero(counters)
        got = fn(x)
        launches = _count(counters)
        gathers = fn.stats["data"]["gathers"]
    finally:
        pm.destroy_distributed()
        torch.backends.cudnn.deterministic = saved
    out = {"bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
           "data_gathers": gathers, "launches": launches}
    log("serving mesh (1, 1) over NCCL at world size 1 against serve: "
        + json.dumps(out))
    if not out["bit_equal"] or gathers != 1:
        raise AssertionError("the NCCL (1, 1) mesh is not serve bit for bit")
    return out


def mesh_within(name, got_d, got_v, want_d, want_v, float32):
    """Meshed detections against a one-process reference at tolerance:
    float32 at `assert_dets_match`'s, bf16 outputs row by row at
    `match_rows_free_labels`'s (one bf16 rounding moves a box by up to an
    eighth of a pixel), every row paired. Returns (label flips, max box
    |d|, max score |d|)."""
    np.testing.assert_array_equal(got_v.sum(1), want_v.sum(1))
    if float32:
        assert_dets_match(got_d, got_v, want_d, want_v)
    flips, box_d, score_d = 0, 0.0, 0.0
    for g, gv, w, wv in zip(got_d, got_v, want_d, want_v):
        f, _, bd, sd = match_rows_free_labels(g[gv], w[wv])
        flips, box_d, score_d = flips + f, max(box_d, bd), max(score_d, sd)
    if flips > INT8_LABEL_FLIPS * want_v.sum():
        raise AssertionError(f"{name}: {flips} labels differ")
    return flips, box_d, score_d


def mesh_check(name, shape, px, rank, ref, float32, exact=True):
    """A rank's meshed result against the one-process `serve` on the card
    at the rank's own batch (`ref["dets"]`, `ref["valid"]`): bit for bit
    if `exact`, else at `mesh_within`'s tolerances; for a data split also
    against one call on the whole batch (`ref["batch"]`) at those
    tolerances (cuDNN may take another algorithm for another batch).
    `float32`: the outputs are float32 (not bf16, not int8 HBM's bf16
    predictions). Launches as one process's where the rank has rows,
    else K2's alone. Returns (bit-equal at its batch, where it is not the
    comparison's (label flips, max box |d|, max score |d|), the same of
    the whole-batch comparison), each None where not made."""
    got_d, got_v = rank["dets"].numpy(), rank["valid"].numpy()
    bits = bool(np.array_equal(got_v, ref["valid"])
                and np.array_equal(got_d, ref["dets"]))
    own = None
    if not bits:
        if exact:
            raise AssertionError(
                f"{name}, rank at {rank['coords']}: not one process's bits: "
                f"valid {got_v.sum(1).tolist()} against "
                f"{ref['valid'].sum(1).tolist()}")
        own = mesh_within(name, got_d, got_v, ref["dets"], ref["valid"],
                          float32)
    want = dict(ref["launches"])
    if not _has_rows(px, shape, rank["coords"]):  # K2 alone
        want = {k: n if k == "nms" else 0 for k, n in want.items()}
    if rank["launches"] != want:
        raise AssertionError(f"{name}, rank at {rank['coords']}: launched "
                             f"{rank['launches']}, want {want}")
    if "batch" not in ref:
        return bits, own, None
    return bits, own, mesh_within(name, got_d, got_v, *ref["batch"],
                                  float32)


def run_mesh(cfg, rng, lines, cases=MESH_CASES, timed=MESH_TIMED,
             cards=None, backend="gloo", exact=True):
    """Phase 14: the serving meshes, MESH_WORLD gloo ranks sharing the
    card (or a `backend` rank on each of `cards`, references on CARD),
    every rank held bit for bit to one process (`exact`) or at
    `mesh_within`'s tolerances, its bit-equality printed. Returns each
    kernel's launches summed over the ranks' checked meshed calls."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    card = CARD
    shared = cards is None
    cards = [card] * MESH_WORLD if shared else list(cards)
    totals = dict.fromkeys(_launch_counters(), 0)
    inp, refs, modules = mesh_inputs(rng, card, cases, timed)
    res = {"card": nvidia_smi() if card != "cpu" else "cpu",
           "world": len(cards), "backend": backend}
    with tempfile.TemporaryDirectory() as root:
        if shared and torch.device(card).type == "cuda":
            name = timed[0]
            res["nccl_1x1"] = mesh_nccl(
                modules[("yolox_s", "float32")], inp["x"][name],
                mesh_kwargs(refs[name]["thr"], None, None), root)
            _add(totals, res["nccl_1x1"]["launches"])
        del modules
        torch.save(inp, Path(root) / "mesh_inputs.pt")
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(root, cards, backend), nprocs=len(cards),
                 join=True)
        res["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(Path(root) / f"mesh_rank{r}.pt",
                            weights_only=False) for r in range(len(cards))]
    res["cases"] = {}
    for name, model, dtype, shape, b, px, mode in inp["cases"]:
        members = [r["cases"][name] for r in ranks if name in r["cases"]]
        if len(members) != shape[0] * shape[1]:
            raise AssertionError(f"{name}: {len(members)} ranks served")
        checked = [mesh_check(name, shape, px, r, refs[name],
                              dtype == "float32" and mode is None, exact)
                   for r in members]
        bits, own, batch = ([c[i] for c in checked] for i in range(3))
        for r in members:
            _add(totals, r["launches"])
        st = members[0]["stats"]["space"]
        res["cases"][name] = {
            "valid": refs[name]["valid"].sum(1).tolist(),
            "threshold": refs[name]["thr"], "gap": refs[name]["gap"],
            "bit_equal": bits, "not_bit_equal": own, "whole_batch": batch,
            "exchanges": [r["stats"]["space"]["exchanges"] for r in members],
            "exchange_bytes": [r["stats"]["space"]["exchange_bytes"]
                               for r in members],
            "gather_bytes": st["gather_bytes"],
            "launches": [r["launches"] for r in members]}
        c = res["cases"][name]
        log(f"mesh {name} ({model} {dtype}, {shape}, b{b}, {px} px, int8 "
            f"{mode}): against one process at a rank's batch, bit-equal "
            f"{bits}"
            + ("" if all(bits) else f" (label flips, box max |d|, score max "
               f"|d| where not: {own})")
            + f", {c['valid']} detections an image at "
            f"{c['threshold']:.4f} (gap {c['gap']:.3g})"
            + ("" if batch[0] is None else
               f"; against the whole batch (label flips, box max |d|, score "
               f"max |d|) {batch}")
            + f"; exchanges {c['exchanges']}, bytes {c['exchange_bytes']}")
    res["times"] = [r["times"] for r in ranks if r["times"]]
    what = ("what a rank pays on a shared card: no scaling figure" if shared
            else f"{backend}, one card a rank")
    for r in ranks:
        for name, t in r["times"].items():
            log(f"mesh times, rank {r['rank']}, {name} ({what}): meshed "
                f"{t['meshed_ms']:.3f} ms against one process "
                f"{t['one_process_ms']:.3f} ms; {t['exchanges']} exchanges a "
                f"call, {t['exchange_bytes']} bytes sent, "
                f"{t['exchange_ms']:.3f} ms of host time in them; gathered "
                f"{t['gather_bytes']} bytes a rank")
    res["launches"] = totals
    res["wall_s"] = time.perf_counter() - t_phase
    log(("phase 14 (serving meshes)" if shared else
         f"serving meshes ({backend}, {len(cards)} ranks)")
        + f" wall: {res['wall_s']:.1f} s; card: {res['card']}")
    lines.append({"mesh": res})
    return totals


# ---------------------------------------------------- the harnesses (15)

# scripts/torch_quant_accuracy.py overfits nano 800 steps on 4 noise
# images of 128 px by default, ~116 s on the card (eager steps of ~145 ms,
# host-bound, nearly the same for 2 images as for 4); the phase takes the
# steps of JAX's test setting (300) and the script's 4 images, so that
# the floor rests on ~10 detections, not the ~6 of JAX's 2 images
HARNESS_STEPS = 300
HARNESS_IMAGES = 4
HARNESS_SIZE = 128
HARNESS_CONF = 0.2
# JAX's floor for the overfit model (`tests/test_quant.py`): at abs-max
# calibration both int8 modes agree with float32 at >= 0.8 (IoU-style set
# agreement) with a score MAD <= 0.08, over >= 2 float detections
HARNESS_MIN_DETS, HARNESS_AGREEMENT, HARNESS_SCORE_MAD = 2, 0.8, 0.08
# The table is also measured over the overfit images and copies of them
# rolled by these offsets (px, both axes; most off the 32 px grid of the
# coarsest level): tens of detections more, many of them near the
# threshold, where the floor is not held (JAX holds it on the overfit
# images alone)
HARNESS_POOL_ROLLS = (8, 16, 24, 40, 48, 56, 72, 88)
HARNESS_ROLL = 32      # px: the rolled copies of the card-vs-CPU check
HARNESS_EVAL_N, HARNESS_EVAL_B, HARNESS_EVAL_MODEL = 500, 32, "s"
GATE_SEED = 3
GATE_SIZES = ((480, 640), (640, 427), (375, 500))


def harness_scripts():
    """The three harnesses of `scripts/`: (torch_quant_accuracy,
    torch_eval_at_scale, torch_verify_pretrained)."""
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        import torch_eval_at_scale
        import torch_quant_accuracy
        import torch_verify_pretrained
    finally:
        sys.path.remove(scripts)
    return torch_quant_accuracy, torch_eval_at_scale, torch_verify_pretrained


def amplified_nano_pth(path, seed=GATE_SEED):
    """The gate's fixture: a seeded nano whose prediction convs are
    amplified (torch's seeded normal init: objectness and class weights
    N(0, 1e6), regression N(0, 1e5), objectness bias -6), so that on
    `gate_images` it detects 5 / 2 / 1 objects at 0.5 with scores that
    clear 0.5 by >= 0.011 and each other by >= 0.0019. Saved as a `.pth`
    at `path` (built on the CPU); returns the module."""
    import torch

    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.models.weights import save_pth_state_dict

    module = YoloxModule.from_config(
        YoloxConfig.get_named_config("yolox_nano"), rng_seed=seed,
        device="cpu")
    torch.manual_seed(seed)
    with torch.no_grad():
        for conv in module.head.obj_preds:
            conv.weight.normal_(0, 1e6)
            conv.bias.fill_(-6.0)
        for conv in module.head.cls_preds:
            conv.weight.normal_(0, 1e6)
            conv.bias.fill_(0.0)
        for conv in module.head.reg_preds:
            conv.weight.normal_(0, 1e5)
            conv.bias.zero_()
    save_pth_state_dict(module.state_dict(), path)
    return module


def gate_images(root, seed=0):
    """Three PNG files of filled rectangles on a flat background, of the
    `GATE_SIZES`, under `root`; returns their paths."""
    import cv2

    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(GATE_SIZES):
        img = np.full((h, w, 3), int(rng.integers(40, 216)), np.uint8)
        for _ in range(6):
            x0, y0 = int(rng.uniform(0, w * 0.6)), int(rng.uniform(0, h * 0.6))
            x1 = x0 + int(rng.uniform(20, w * 0.4))
            y1 = y0 + int(rng.uniform(20, h * 0.4))
            color = tuple(int(c) for c in rng.integers(0, 255, 3))
            cv2.rectangle(img, (x0, y0), (x1, y1), color, -1)
        path = Path(root) / f"{i:012d}.png"
        cv2.imwrite(str(path), img)
        paths.append(str(path))
    return paths


def expectations_of(results):
    """`Detections` dicts -> the gate's expectation rows."""
    return [{"labels": [int(v) for v in r["labels"]],
             "scores": [float(v) for v in r["scores"]],
             "bboxes": [[float(v) for v in b] for b in r["bboxes"]]}
            for r in results]


@contextlib.contextmanager
def offline_weights_cache(home):
    """Within the block the package's weights cache is `home` (empty) and
    a download raises at once: no request leaves the machine."""
    import urllib.request

    def refuse(*args, **kwargs):
        raise OSError("downloads are off in this run")

    saved = (os.environ.get("YOLOX_HOME"), urllib.request.urlretrieve)
    os.environ["YOLOX_HOME"] = str(home)
    urllib.request.urlretrieve = refuse
    try:
        yield
    finally:
        if saved[0] is None:
            os.environ.pop("YOLOX_HOME", None)
        else:
            os.environ["YOLOX_HOME"] = saved[0]
        urllib.request.urlretrieve = saved[1]


@contextlib.contextmanager
def card_stem_outputs():
    """Within the block K1's outputs on the card are kept by input, and
    the CPU's stem on an image the card saw is held to them (its plain
    version on the card's weights, `stem_limit`) and then returns them.
    The int8 HBM mode requantizes the stem's float32 output, which the
    tensor cores and the CPU sum apart by up to K1's tolerance: an output
    within that of a code boundary takes another code on each device, and
    the trained layers after it carry the difference on (raw rms 0.053 at
    B 8 from 2 such codes). With the card's stem output both devices run
    the same codes from there on. Yields {"substituted": calls, "worst":
    the largest |K1 - plain| over its tolerance}."""
    import hashlib

    import torch

    from yolox_tpu_torch.models import blocks
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act_plain

    real = blocks.stem_conv_bn_act
    seen, res = {}, {"substituted": 0, "worst": 0.0}

    def key(x):
        x = x.detach().cpu().contiguous()
        return (tuple(x.shape), str(x.dtype),
                hashlib.sha1(x.numpy().tobytes()).hexdigest())

    def stem(x, wb, scale, bias, act="silu", out_dtype=torch.float32):
        if x.device.type == "cuda":
            y = real(x, wb, scale, bias, act, out_dtype)
            seen[key(x)] = [t.cpu() for t in (wb, scale, bias, y)]
            return y
        if key(x) not in seen:
            return real(x, wb, scale, bias, act, out_dtype)
        cw, cs, cb, cy = seen[key(x)]
        ref = stem_conv_bn_act_plain(x, cw, cs, cb, act, out_dtype).float()
        r = ((cy.float() - ref).abs()
             / stem_limit(x, cw, cs, ref, out_dtype)).max().item()
        if not r <= 1:
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({r:.3g} of its tolerance)")
        res["substituted"] += 1
        res["worst"] = max(res["worst"], r)
        return cy

    blocks.stem_conv_bn_act = stem
    try:
        yield res
    finally:
        blocks.stem_conv_bn_act = real


def harness_accuracy(tqa, counters):
    """(a) `torch_quant_accuracy`: nano overfit on the card, its four int8
    variants against float32 on the overfit images (JAX's table, JAX's
    floor required) and on those and their `HARNESS_POOL_ROLLS` copies
    (reported), the launch counters read around the training and both
    tables; then on the trained weights the card against the CPU: float
    `serve` at `assert_dets_match`'s tolerances, each variant (the card's
    table moved to the CPU) through `int8_card_vs_cpu` at phase 11's
    tolerances (in the HBM mode the CPU's stem held to K1's output, then
    given it: `card_stem_outputs`), on the images and copies rolled by
    `HARNESS_ROLL` px, at a threshold in a gap of the CPU's scores that
    keeps dozens of candidates an image (`mesh_threshold`: a variant may
    keep no detection at the harness's own threshold). Returns (result,
    launches)."""
    import torch

    from yolox_tpu_torch import YoloxModule

    _zero(counters)
    t0 = time.perf_counter()
    module, x, _, cfg = tqa.train_overfit(HARNESS_STEPS, HARNESS_IMAGES,
                                          HARNESS_SIZE, device=CARD)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    variants = tqa.int8_variants(module, x)
    table = tqa.measure(module, cfg, x, HARNESS_CONF, variants=variants)
    pool = torch.cat([x] + [torch.roll(x, (r, r), dims=(1, 2))
                            for r in HARNESS_POOL_ROLLS])
    pooled = tqa.measure(module, cfg, pool, HARNESS_CONF, variants=variants)
    n = _count(counters)
    measure_s = time.perf_counter() - t0 - train_s
    log("QUANT_ACCURACY " + json.dumps(table))
    log(f"QUANT_ACCURACY over {len(pool)} frames " + json.dumps(pooled))
    if table["n_float_dets"] < HARNESS_MIN_DETS:
        raise AssertionError(f"the overfit model made "
                             f"{table['n_float_dets']} float detections")
    for name in ("ladder-amax", "hbm-amax"):
        r = table[name]
        if (r["agreement"] < HARNESS_AGREEMENT or r["score_mad"] is None
                or r["score_mad"] > HARNESS_SCORE_MAD):
            raise AssertionError(f"{name} under JAX's floor: {r}")

    cpu = YoloxModule.from_config(cfg, device="cpu")
    cpu.load_params(module.state_dict())
    shapes = int8_conv_shapes(cpu, HARNESS_SIZE, 1)
    n_q1 = sum(c for sh, c in shapes.items() if sh[-1] == 1)
    n_q2 = sum(c for sh, c in shapes.items() if sh[-1] > 1)
    # per table float serve 1 and HBM serves 2, and calibrations 2, run
    # K1; the ladder's stem is its folded conv on Q1
    want = _only(counters, stem=8, nms=10, int8_conv=8 * n_q1 - 4,
                 int8_dwconv=8 * n_q2)
    if n != want:
        raise AssertionError(f"harness launches {n}, want {want}")
    log(f"harness (a): {HARNESS_STEPS} steps in {train_s:.1f} s, the table "
        f"in {measure_s:.1f} s; launches {n}")

    kw = dict(conf_thre=HARNESS_CONF, nms_thre=cfg.nmsthre, max_det=32)
    got_d, got_v = module.serve(x, **kw)
    want_d, want_v = cpu.serve(x.cpu(), **kw)
    assert_dets_match(got_d.cpu().numpy(), got_v.cpu().numpy(),
                      want_d.numpy(), want_v.numpy())
    cfg.test_size = (HARNESS_SIZE, HARNESS_SIZE)  # Yolox letterboxes nothing
    imgs = np.clip(np.rint(x.cpu().numpy()), 0, 255).astype(np.uint8)
    frames = list(imgs) + [np.roll(f, HARNESS_ROLL, axis=(0, 1))
                           for f in imgs]
    held = {}
    for name, qtab, hbm in variants:
        mode = "hbm" if hbm else "ladder"
        host_tab = {k: v.cpu() for k, v in qtab.items()}
        raw = np.concatenate(int8_raw(cpu, np.stack(frames), mode, host_tab),
                             1)
        thr, _ = mesh_threshold(raw[..., 4] * raw[..., 5:].max(-1))
        with card_stem_outputs() as stems:
            held[name] = int8_card_vs_cpu(
                f"nano overfit {name}", module, cpu, host_tab, (mode,),
                frames, n_q1, n_q2, threshold=thr)[mode]
        if hbm and not stems["substituted"]:
            raise AssertionError(f"{name}: the CPU ran no stem of the card's")
        held[name] += (stems,)
    return {"table": table, "pooled": pooled, "train_s": train_s,
            "measure_s": measure_s,
            "float_dets_card_vs_cpu": int(got_v.sum()),
            "card_vs_cpu": held, "launches": n}, n


def harness_eval(teas, counters, root):
    """(b) `torch_eval_at_scale` at HARNESS_EVAL_N images, B
    HARNESS_EVAL_B, bf16, under `root`: rc 0, detections on every image,
    K1 and K2 once a batch. Returns (report, launches)."""
    _zero(counters)
    rep = teas.run(images=HARNESS_EVAL_N, model=HARNESS_EVAL_MODEL,
                   batch=HARNESS_EVAL_B, root=root / "set",
                   ckpt_dir=root / "ckpt", device=CARD)
    n = _count(counters)
    ids = rep.pop("image_ids")
    log("EVAL_AT_SCALE " + json.dumps(rep))
    if rep["rc"] != 0 or ids != list(range(HARNESS_EVAL_N)):
        raise AssertionError(f"eval at scale: rc {rep['rc']}, "
                             f"{len(ids)} of {HARNESS_EVAL_N} images with "
                             f"detections")
    batches = -(-HARNESS_EVAL_N // HARNESS_EVAL_B)
    want = _only(counters, stem=batches, nms=batches)
    if n != want:
        raise AssertionError(f"eval at scale launches {n}, want {want}")
    return {**rep, "launches": n}, n


def harness_gate(tvp, counters, root):
    """(c) `torch_verify_pretrained`, leg 1 on the card against
    expectations from the CPU's plain path (`amplified_nano_pth`,
    `gate_images`): exit 0 (launches read around it), 1 on boxes moved by
    0.5 px, 2 without weights (downloads refused). Returns (result,
    launches)."""
    from PIL import Image

    from yolox_tpu_torch import Yolox, YoloxConfig

    root.mkdir(parents=True, exist_ok=True)
    ckpt = root / "yolox_nano.pth"
    amplified_nano_pth(ckpt)
    images = gate_images(root)
    cpu = Yolox.from_pretrained(
        str(ckpt), config=YoloxConfig.get_named_config("yolox_nano"),
        device="cpu")
    exp = expectations_of(cpu([Image.open(p) for p in images],
                              threshold=0.5))
    if not all(e["labels"] for e in exp):
        raise AssertionError("the gate's fixture left an image without "
                             "detections")
    bad = json.loads(json.dumps(exp))
    for e in bad:
        for box in e["bboxes"]:
            box[0] += 0.5
    for name, rows in (("exp", exp), ("bad", bad)):
        (root / f"{name}.json").write_text(json.dumps({"yolox_nano": rows}))
    argv = ["--models", "yolox_nano", "--skip-map", "--skip-train",
            "--device", CARD]
    golden = ["--weights-dir", str(root), "--images", *images]
    _zero(counters)
    rc0 = tvp.main(argv + golden + ["--expectations", str(root / "exp.json"),
                                    "--out", str(root / "pass.json")])
    n = _count(counters)
    rc1 = tvp.main(argv + golden + ["--expectations", str(root / "bad.json"),
                                    "--out", str(root / "fail.json")])
    with offline_weights_cache(root / "home"):
        rc2 = tvp.main(argv + ["--weights-dir", str(root / "none"),
                               "--out", str(root / "missing.json")])
    legs = json.loads((root / "pass.json").read_text())[
        "models"]["yolox_nano"]["goldens"]
    res = {"exits": [rc0, rc1, rc2], "detections": [len(e["labels"])
                                                    for e in exp],
           "goldens": legs, "launches": n}
    log("gate: " + json.dumps(res))
    if [rc0, rc1, rc2] != [0, 1, 2]:
        raise AssertionError(f"gate exits {[rc0, rc1, rc2]}, want [0, 1, 2]")
    if n != _only(counters, stem=1, nms=1):
        raise AssertionError(f"gate launches {n}")
    return res, n


def run_harnesses(lines):
    """Phase 15: the three harnesses on the card (`harness_accuracy`,
    `harness_eval`, `harness_gate`). Returns each kernel's launches over
    their main-path runs."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    if torch.device(CARD).type != "cuda":
        raise RuntimeError(f"phase 15 runs the harnesses on a CUDA device, "
                           f"not {CARD}: its launch counts come from the "
                           f"kernels")
    tqa, teas, tvp = harness_scripts()
    counters = _launch_counters()
    totals = dict.fromkeys(counters, 0)
    res = {"card": nvidia_smi()}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for key, run in (
                ("accuracy", lambda: harness_accuracy(tqa, counters)),
                ("eval_at_scale", lambda: harness_eval(teas, counters,
                                                       root / "eval")),
                ("gate", lambda: harness_gate(tvp, counters,
                                              root / "gate"))):
            t0 = time.perf_counter()
            res[key], n = run()
            res[key]["wall_s"] = time.perf_counter() - t0
            _add(totals, n)
    res["launches"] = totals
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15 (harnesses) wall: {res['wall_s']:.1f} s; card: "
        f"{res['card']}")
    lines.append({"harnesses": res})
    return totals


# ------------------------------------------------- phase 16: profilers

PROFILE_MODEL = "s"
PROFILE_SERVE_B = 32
# 2 serve iterations left the trace report 16% under the stage's device
# ms on an H100 80GB HBM3 at 700 W (limit 15%)
PROFILE_SERVE_ITERS = 4
PROFILE_TRAIN_B = 16
PROFILE_AUG_B = 16
# 2 until phase 18 needed the time (~12 s on an H100 80GB HBM3, 700 W)
PROFILE_STEP_ITERS = 1
PROFILE_AB_DETS, PROFILE_AB_IMAGES = 256_000, 250
# a roofline share above this means a wrong count, not a fast kernel
PROFILE_ROOF_LIMIT = 1.05
# each cumulative serve stage's device ms is at least the one before it,
# within this share (the shared part's kernels may take other times)
PROFILE_RISE_TOL = 0.05
# the trace report's device time an iteration against the full-serve
# stage's device ms (kernel time alone against queued elapsed time)
PROFILE_TRACE_TOL = 0.15


def profiler_scripts():
    """The profiling tools of `scripts/`: (torch_serve_traffic_model,
    torch_profile_serve, torch_trace_report, torch_profile_train,
    torch_profile_augment, torch_eval_memory_ab)."""
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        import torch_eval_memory_ab
        import torch_profile_augment
        import torch_profile_serve
        import torch_profile_train
        import torch_serve_traffic_model
        import torch_trace_report
    finally:
        sys.path.remove(scripts)
    return (torch_serve_traffic_model, torch_profile_serve,
            torch_trace_report, torch_profile_train, torch_profile_augment,
            torch_eval_memory_ab)


def _stage_launches(stage, **want):
    """A stage row's launches against `want` (0 for kernels not named)."""
    got = stage["launches"]
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{stage['stage']}: launches {got}, want {want}")


def check_serve_profile(res, on_card):
    """Phase 16's checks of one `torch_profile_serve` result: each stage's
    launches (K1 once, K2 once in the full serve) and, on a card, every
    roofline share at most PROFILE_ROOF_LIMIT and device ms rising stage
    by stage within PROFILE_RISE_TOL."""
    stages = res["stages"]
    if [s["stage"] for s in stages] != [
            "backbone", "backbone+head raw", "full serve (+decode+NMS)"]:
        raise AssertionError(f"serve stages {[s['stage'] for s in stages]}")
    for s in stages:
        if not np.isfinite(s["checksum"]):
            raise AssertionError(f"{s['stage']}: checksum {s['checksum']}")
    if not on_card:
        return
    _stage_launches(stages[0], stem_conv_bn_act=1)
    _stage_launches(stages[1], stem_conv_bn_act=1)
    _stage_launches(stages[2], stem_conv_bn_act=1, nms_keep=1)
    for s in stages:
        for share in ("mfu_pct", "hbm_pct"):
            if not s[share] <= 100 * PROFILE_ROOF_LIMIT:
                raise AssertionError(
                    f"serve {res['dtype']} {s['stage']}: {share} "
                    f"{s[share]:.1f}%: a count is wrong")
    dev = [s["device_ms"] for s in stages]
    for lo, hi in zip(dev, dev[1:]):
        if lo > hi * (1 + PROFILE_RISE_TOL):
            raise AssertionError(f"serve {res['dtype']} stages' device ms "
                                 f"{dev} do not rise")


def check_trace_report(rep, full_serve_ms, on_card):
    """The trace report of the full-serve trace: a device track, its time
    an iteration within PROFILE_TRACE_TOL of the stage's device ms, K1's
    and K2's kernels among its rows."""
    if not on_card:
        return
    names = [op["name"] for op in rep["ops"]]
    if not rep["tracks"]:
        raise AssertionError("trace report: no device track")
    per_iter_ms = rep["us_per_iter"] / 1e3
    if abs(per_iter_ms - full_serve_ms) > PROFILE_TRACE_TOL * full_serve_ms:
        raise AssertionError(f"trace report {per_iter_ms:.3f} ms an "
                             f"iteration against full serve's device "
                             f"{full_serve_ms:.3f} ms")
    for kernel in ("stem_", "nms_kernel"):
        if not any(kernel in n for n in names):
            raise AssertionError(f"trace report: no {kernel} kernel among "
                                 f"{len(names)} rows")


def check_train_profile(res, n_convs, on_card):
    """K1 once in the eval-mode forward, K3 and K4 once a 1x1 SiLU conv in
    the backward and the full step (`--fused-bwd`), no other launch."""
    if [s["stage"] for s in res["stages"]] != [
            "fwd eval-mode (bf16)", "fwd train-mode (BN batch stats)",
            "fwd + SimOTA loss", "fwd + loss + grad (bwd)",
            "full train step"]:
        raise AssertionError("train stages")
    for s in res["stages"]:
        if not np.isfinite(s["checksum"]):
            raise AssertionError(f"{s['stage']}: checksum {s['checksum']}")
    if not on_card:
        return
    eval_fwd, train_fwd, fwd_loss, grad, step = res["stages"]
    _stage_launches(eval_fwd, stem_conv_bn_act=1)
    _stage_launches(train_fwd)
    _stage_launches(fwd_loss)
    _stage_launches(grad, reduce_sums=n_convs, main_1x1=n_convs)
    _stage_launches(step, reduce_sums=n_convs, main_1x1=n_convs)


def check_augment_profile(res, on_card):
    """K5 once a batch, and its kernel attributed to a frame of the
    package in the per-op table."""
    if not np.isfinite(res["checksum"]):
        raise AssertionError(f"augment checksum {res['checksum']}")
    if not on_card:
        return
    if res["launches"]["shear_xy"] != 1:
        raise AssertionError(f"augment launches {res['launches']}")
    rows = [op for op in res["ops"] if "shear_xy_kernel" in op["name"]]
    if not rows or not all("yolox_tpu_torch/" in op["frame"] for op in rows):
        raise AssertionError(f"augment: K5 rows {rows}")


def run_profilers(n_convs, lines):
    """Phase 16: the profiling tools of `scripts/` on yolox-s, each
    through its `main()` (the evaluation-memory A/B through its child
    processes), with the launch counters read around each run and the
    checks above. Returns each kernel's launches over the phase."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    on_card = torch.device(CARD).type == "cuda"
    ttm, tps, ttr, ttp, tpa, tem = profiler_scripts()
    counters = _launch_counters()
    totals = dict.fromkeys(counters, 0)
    res = {"card": nvidia_smi() if on_card else None, "wall_s": {}}
    dev = ["--device", "cuda" if on_card else "cpu"]

    def counted(key, fn):
        t0 = time.perf_counter()
        _zero(counters)
        out = fn()
        _add(totals, _count(counters))
        res["wall_s"][key] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--model", PROFILE_MODEL, "--batch", str(PROFILE_SERVE_B),
                  "--iters", str(PROFILE_SERVE_ITERS)] + dev
        res["traffic"] = counted("traffic", lambda: ttm.main(
            ["--model", PROFILE_MODEL, "--batch", str(PROFILE_SERVE_B)]))
        res["traffic"].pop("rows")
        serve = counted("serve_bf16", lambda: tps.main(
            common + ["--trace", tmp]))
        check_serve_profile(serve, on_card)
        rep = counted("trace_report", lambda: ttr.main(
            [tmp, "--iters", str(PROFILE_SERVE_ITERS), "--top", "100000"]))
        check_trace_report(rep, serve["stages"][-1]["device_ms"], on_card)
        res["serve_bf16"] = serve
        res["trace_report"] = {**rep, "ops": rep["ops"][:15]}
        res["serve_f32"] = counted("serve_f32", lambda: tps.main(
            common + ["--dtype", "float32"]))
        check_serve_profile(res["serve_f32"], on_card)
        res["train"] = counted("train", lambda: ttp.main(
            ["--model", PROFILE_MODEL, "--batch", str(PROFILE_TRAIN_B),
             "--iters", str(PROFILE_STEP_ITERS), "--fused-bwd"] + dev))
        check_train_profile(res["train"], n_convs, on_card)
        aug = counted("augment", lambda: tpa.main(
            ["--batch", str(PROFILE_AUG_B), "--iters",
             str(PROFILE_STEP_ITERS), "--trace", str(Path(tmp) / "aug"),
             "--top", "100000"] + dev))
        check_augment_profile(aug, on_card)
        res["augment"] = {**aug, "ops": aug["ops"][:15]}
    ab = counted("eval_memory_ab", lambda: tem.run(PROFILE_AB_DETS,
                                                   PROFILE_AB_IMAGES))
    if any("error" in r for r in ab) or ab[0]["ap"] != ab[1]["ap"]:
        raise AssertionError(f"evaluation-memory A/B: {ab}")
    res["eval_memory_ab"] = ab
    if on_card:
        missing = [k for k in ("stem", "nms", "reduce_sums", "main_1x1",
                               "shear_xy") if not totals[k]]
        if missing:
            raise AssertionError(f"phase 16 launched no {missing}")
    res["launches"] = totals
    res["wall_s"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 16 (profilers) wall: {res['wall_s']['phase']:.1f} s; "
        f"card: {res['card']}")
    lines.append({"profilers": res})
    return totals


# ------------------------------------- phase 17: the augmentation A/Bs

# The distribution check of the device augmentation against the host
# pipeline, at the JAX package's sizes (`tests/test_augment_equivalence.py`)
AUGEQ_S = 128          # output size
AUGEQ_IMAGES = 16      # base images
AUGEQ_SAMPLES = 384    # samples a pipeline
AUGEQ_BATCH = 64       # device samples a batch
AUGEQ_GATE_N = 128     # samples of the MixUp gate check
AUGEQ_SEED = 7         # the device generator's seed (JAX's key 7)
AUGEQ_HYPER = dict(degrees=10.0, translate=0.1, shear=2.0)
AUGEQ_SCALES = (0.5, 1.5)
# JAX's bounds: |z| below AUGEQ_Z on these metrics (at N 384, any shift
# below ~0.3 of a sample's sigma) ...
AUGEQ_Z = 4.0
AUGEQ_SHARED = ("n_boxes", "box_w", "box_h", "box_area", "pad_frac",
                "pix_mean")
# ... and the multi-pass interpolation's softening, (host - device) /
# host, within AUGEQ_SOFTENING on these
AUGEQ_SOFT = ("pix_std", "grad_energy")
AUGEQ_SOFTENING = (-0.02, 0.12)
# torch_augment_ab's outcome bounds (JAX's `test_trainer_e2e.py`): the
# run-average loss below this (init ~12.5), at least one confident correct
# detection an arm, the arms' relative loss gap below AB_LOSS_GAP
AB_LOSS_MAX = 10.5
AB_LOSS_GAP = 0.2
AB_EPOCHS = 50         # torch_augment_ab's default
# torch_augment_outcome_ab here: 12 epochs, not the script's 150, for the
# script's time limit (on an H100 80GB HBM3 at 700 W 150 took ~170 s of
# the phase, 50 ~60 s, 25 ~45 s, which phase 18 needed; at 25 the pre-L1
# loss fell 10.68 -> 10.51 host, 10.77 -> 10.44 device); at 150 neither
# package's arms make a detection above its test_conf on the noise images
# (AP 0: JAX's script on the CPU, the port on the H100), so the AP is
# recorded, not bounded
OUTCOME_EPOCHS = 12


class AugeqDataset:
    """The distribution check's base set (JAX's `base_dataset` fixture):
    smooth gradients with class-coloured rectangles at the label boxes,
    so pixel statistics follow geometry and labels sit on content."""

    def __init__(self, n=AUGEQ_IMAGES, s=AUGEQ_S, seed=0):
        rng = np.random.default_rng(seed)
        self.imgs, self.labs = [], []
        for _ in range(n):
            h = int(rng.integers(s // 2, s + 1))
            w = int(rng.integers(s // 2, s + 1))
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.stack([
                xx / max(w - 1, 1) * 255,
                yy / max(h - 1, 1) * 255,
                (xx + yy) / max(h + w - 2, 1) * 255,
            ], -1).astype(np.uint8)
            k = int(rng.integers(1, 4))
            lab = np.zeros((k, 5), np.float32)
            for j in range(k):
                bw = float(rng.uniform(16, w / 2))
                bh = float(rng.uniform(16, h / 2))
                x = float(rng.uniform(0, w - bw))
                y = float(rng.uniform(0, h - bh))
                cls = int(rng.integers(0, 3))
                lab[j] = [x, y, x + bw, y + bh, cls]
                img[int(y):int(y + bh), int(x):int(x + bw), cls] = 230
            self.imgs.append(img)
            self.labs.append(lab)

    def __len__(self):
        return len(self.imgs)

    def pull_item(self, idx):
        return (self.imgs[idx].copy(), self.labs[idx].copy(),
                self.imgs[idx].shape[:2], idx)

    def load_anno(self, idx):
        return self.labs[idx]


def augeq_host_samples(ds, n=AUGEQ_SAMPLES):
    """n samples of the host pipeline (MosaicDetection + TrainTransform,
    MixUp on), sample i from seed 1000 + i: (images, labels) numpy."""
    from yolox_tpu_torch.data import MosaicDetection, TrainTransform

    md = MosaicDetection(
        ds, img_size=(AUGEQ_S, AUGEQ_S), mosaic=True,
        preproc=TrainTransform(max_labels=120), mosaic_scale=AUGEQ_SCALES,
        mixup_scale=(0.5, 1.5), enable_mixup=True, **AUGEQ_HYPER)
    imgs, labs = [], []
    for i in range(n):
        img, lab, *_ = md[(True, i % len(ds), 1000 + i)]
        imgs.append(np.asarray(img))
        labs.append(np.asarray(lab))
    return np.stack(imgs), np.stack(labs)


def augeq_tiles(ds, start, batch):
    """The raw tiles of device samples start .. start + batch - 1 (sample
    j from seed 2000 + j, as JAX's check): (tiles, hw, labels) numpy."""
    from yolox_tpu_torch.data import TileDataset

    td = TileDataset(ds, tile_size=AUGEQ_S)
    items = [td[(True, (start + b) % len(ds), 2000 + start + b)]
             for b in range(batch)]
    return (np.stack([t for t, _, _, _ in items]),
            np.stack([h for _, _, h, _ in items]),
            np.stack([lab for _, lab, _, _ in items]))


def augeq_draws(generator, n=AUGEQ_SAMPLES, batch=AUGEQ_BATCH, **kw):
    """The draws of n device samples, a batch at a time, from `generator`
    (on its device), as `device_augment_batch` takes them."""
    from yolox_tpu_torch.data import sample_augment_draws

    return [sample_augment_draws(batch, generator, (AUGEQ_S, AUGEQ_S),
                                 scales=AUGEQ_SCALES, mixup_scale=(0.5, 1.5),
                                 **AUGEQ_HYPER, **kw)
            for _ in range(0, n, batch)]


def augeq_device_samples(ds, draws, device, n=AUGEQ_SAMPLES, **kw):
    """The device engine's samples on `device` from `draws` (a list, one
    entry a batch): `augment_with_draws` at the check's settings, MixUp
    on, float32 images (the products and K5 in the device's own compute
    dtype: bf16 on a card). Returns (images, labels) numpy."""
    import torch

    from yolox_tpu_torch.data import augment_with_draws

    imgs, labs = [], []
    for k, d in enumerate(draws):
        batch = len(d["yc"])
        tiles, hw, lab = (torch.from_numpy(a).to(device) for a in
                          augeq_tiles(ds, k * batch, batch))
        im, lb = augment_with_draws(
            tiles, hw, lab, {key: v.to(device) for key, v in d.items()},
            (AUGEQ_S, AUGEQ_S), max_labels=120,
            degrees=AUGEQ_HYPER["degrees"], shear=AUGEQ_HYPER["shear"],
            **{"enable_mixup": True, **kw})
        imgs.append(im.float().cpu().numpy())
        labs.append(lb.cpu().numpy())
    return np.concatenate(imgs)[:n], np.concatenate(labs)[:n]


def augeq_metrics(imgs, labs):
    """Per-sample metrics (JAX's `_per_image_metrics`): pixel mean and
    std, the pad fraction (within 0.75 of 114), gradient energy, and the
    valid boxes' count and mean width, height and area."""
    m = {}
    m["pix_mean"] = imgs.mean((1, 2, 3))
    m["pix_std"] = imgs.std((1, 2, 3))
    m["pad_frac"] = (np.abs(imgs - 114.0) < 0.75).mean((1, 2, 3))
    m["grad_energy"] = (np.abs(np.diff(imgs, axis=2)).mean((1, 2, 3))
                        + np.abs(np.diff(imgs, axis=1)).mean((1, 2, 3)))
    valid = labs[..., 3] * labs[..., 4] > 0
    m["n_boxes"] = valid.sum(1).astype(np.float64)
    wv = np.where(valid, labs[..., 3], np.nan)
    hv = np.where(valid, labs[..., 4], np.nan)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # samples, no box
        m["box_w"] = np.nanmean(wv, 1)
        m["box_h"] = np.nanmean(hv, 1)
        m["box_area"] = np.nanmean(wv * hv, 1)
    return m


def augeq_z(x, y):
    """Two-sample z of the means over the finite entries."""
    x = x[np.isfinite(x)]
    y = y[np.isfinite(y)]
    se = np.sqrt(x.var() / len(x) + y.var() / len(y))
    return float((x.mean() - y.mean()) / se)


def augeq_compare(hm, dm):
    """{"z": every metric's z (first set minus second), "softening":
    (first - second) / first of the means on AUGEQ_SOFT}."""
    return {"z": {k: augeq_z(hm[k], dm[k]) for k in hm},
            "softening": {k: float((hm[k].mean() - dm[k].mean())
                                   / hm[k].mean()) for k in AUGEQ_SOFT}}


def augeq_failures(cmp):
    """The bounds `cmp` (host against device) leaves: |z| >= AUGEQ_Z on
    AUGEQ_SHARED, softening outside AUGEQ_SOFTENING."""
    lo, hi = AUGEQ_SOFTENING
    bad = [f"{k}: z {cmp['z'][k]:.3f}" for k in AUGEQ_SHARED
           if not abs(cmp["z"][k]) < AUGEQ_Z]
    bad += [f"{k}: softening {cmp['softening'][k]:.4f}" for k in AUGEQ_SOFT
            if not lo <= cmp["softening"][k] <= hi]
    return bad


def augeq_mixup_rate(ds, generator, device):
    """The share of AUGEQ_GATE_N samples that MixUp changes (by more than
    one level anywhere) on a set where every image has labels: the same
    draws with MixUp on and off, flip and HSV off. The reference mixes
    whenever the mosaic kept any label row (clipped ones too), so 1.0."""
    import torch

    from yolox_tpu_torch.data import augment_with_draws

    (d,) = augeq_draws(generator, AUGEQ_GATE_N, AUGEQ_GATE_N,
                       flip_prob=0.0, hsv_prob=0.0)
    tiles, hw, lab = (torch.from_numpy(a).to(device)
                      for a in augeq_tiles(ds, 0, AUGEQ_GATE_N))
    im = {}
    for mix in (True, False):
        im[mix], _ = augment_with_draws(
            tiles, hw, lab, d, (AUGEQ_S, AUGEQ_S), max_labels=120,
            degrees=AUGEQ_HYPER["degrees"], shear=AUGEQ_HYPER["shear"],
            enable_mixup=mix, hsv_prob=0.0)
    mixed = (im[True].float() - im[False].float()).abs().amax((1, 2, 3)) > 1
    return float(mixed.float().mean())


def augment_ab_scripts():
    """The augmentation A/Bs of `scripts/`: (torch_augment_ab,
    torch_augment_outcome_ab)."""
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        import torch_augment_ab
        import torch_augment_outcome_ab
    finally:
        sys.path.remove(scripts)
    return torch_augment_ab, torch_augment_outcome_ab


def augeq_on_card(counters):
    """Phase 17 (a): the device engine's AUGEQ_SAMPLES samples on CARD
    from a seeded generator there, against the host pipeline's, with
    JAX's bounds; the same draws through the CPU's plain path, card
    against CPU z printed; the MixUp gate rate on CARD. Returns (result,
    launches)."""
    import torch

    ds = AugeqDataset()
    t0 = time.perf_counter()
    hm = augeq_metrics(*augeq_host_samples(ds))
    host_s = time.perf_counter() - t0
    gen = torch.Generator(device=CARD).manual_seed(AUGEQ_SEED)
    draws = augeq_draws(gen)
    _zero(counters)
    t0 = time.perf_counter()
    card = augeq_metrics(*augeq_device_samples(ds, draws, CARD))
    card_s = time.perf_counter() - t0
    gate = augeq_mixup_rate(
        ds, torch.Generator(device=CARD).manual_seed(AUGEQ_SEED), CARD)
    n = _count(counters)
    cpu = augeq_metrics(*augeq_device_samples(ds, draws, "cpu"))
    res = {"host_vs_card": augeq_compare(hm, card),
           "host_vs_cpu": augeq_compare(hm, cpu),
           "card_vs_cpu_z": augeq_compare(card, cpu)["z"],
           "mixup_gate_rate": gate, "host_s": host_s, "card_s": card_s,
           "launches": n}
    log("phase 17 (a) distribution, host against device, "
        f"{AUGEQ_SAMPLES} samples at {AUGEQ_S} px: "
        + json.dumps({k: res[k] for k in ("host_vs_card", "host_vs_cpu",
                                          "card_vs_cpu_z",
                                          "mixup_gate_rate")}))
    bad = augeq_failures(res["host_vs_card"])
    if bad:
        raise AssertionError(f"the card's device augmentation leaves the "
                             f"host pipeline's distribution: {bad}")
    if gate != 1.0:
        raise AssertionError(f"MixUp gate rate {gate} on the card")
    if torch.device(CARD).type == "cuda":
        # one K5 a batch: the samples' and the gate check's two
        want = len(draws) + 2
        if n["shear_xy"] != want or n["shear_x"]:
            raise AssertionError(f"distribution check launches {n}, want "
                                 f"shear_xy {want}, shear_x 0")
    return res, n


@contextlib.contextmanager
def iteration_launches(counters, records):
    """Within the block, each `Trainer` iteration appends a dict to
    `records`: device-augmented or not (`aug`), with the L1 loss or not
    (`l1`), its loss and its launches. The counters count on the host at
    each launch, so reading them needs no sync."""
    from yolox_tpu_torch.core.trainer import Trainer

    one_iter = Trainer.train_one_iter

    def counted(self):
        rec = {"aug": self._device_augment, "l1": self.use_l1}
        before = {k: f.launches for k, f in counters.items()}
        one_iter(self)
        records.append({**rec, "loss": self.meter["total_loss"].latest,
                        "launches": {k: f.launches - before[k]
                                     for k, f in counters.items()}})

    Trainer.train_one_iter = counted
    try:
        yield
    finally:
        Trainer.train_one_iter = one_iter


def check_ab_iterations(name, records, aug_steps, on_card):
    """K5 once an augmented step of the device arm, never otherwise;
    `shear_x`, K3 and K4 never (`fused_conv_bwd` off)."""
    got = sum(r["aug"] for r in records)
    if got != aug_steps:
        raise AssertionError(f"{name}: {got} augmented steps, want "
                             f"{aug_steps}")
    if not on_card:
        return
    for i, r in enumerate(records):
        n = r["launches"]
        if (n["shear_xy"] != int(r["aug"]) or n["shear_x"]
                or n["reduce_sums"] or n["main_1x1"]):
            raise AssertionError(f"{name}: iteration {i} (augmented "
                                 f"{r['aug']}) launched {n}")


def counted_arms(mod, run, inner, argv, counters):
    """`mod.main(argv)` with the launch counters read around each call of
    `mod.<run>` (an arm), around each of its `Trainer` iterations
    (`iteration_launches`) and around each call of `mod.<inner>` (its
    detection or evaluation). Returns (what main returns, one dict an arm:
    `result`, `launches`, `records`, `inner`)."""
    run_fn, inner_fn = getattr(mod, run), getattr(mod, inner)
    arms = []

    def counted_inner(*a, **kw):
        before = _count(counters)
        out = inner_fn(*a, **kw)
        arms[-1]["inner"] = {k: v - before[k]
                             for k, v in _count(counters).items()}
        return out

    def counted_run(*a, **kw):
        arms.append({"records": []})
        _zero(counters)
        with iteration_launches(counters, arms[-1]["records"]):
            r = run_fn(*a, **kw)
        arms[-1]["launches"] = _count(counters)
        arms[-1]["result"] = r
        return r

    setattr(mod, run, counted_run)
    setattr(mod, inner, counted_inner)
    try:
        out = mod.main(argv)
    finally:
        setattr(mod, run, run_fn)
        setattr(mod, inner, inner_fn)
    return out, arms


def aug_steps(max_epoch, no_aug_epochs, iters):
    """Device-augmented steps of a run from epoch 0: the mosaic closes at
    epoch index max_epoch - no_aug_epochs - 1."""
    return max(max_epoch - no_aug_epochs - 1, 0) * iters


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's default TF32 settings within the block (cuDNN's convs
    may take TF32, matmuls not), the caller's after: the A/B scripts
    train as a user's call does, whatever `main` set for the float32
    comparisons of other phases. Their training is deterministic, so
    under these flags a seed gives the script's own numbers."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def run_augment_abs(lines, ab_epochs=AB_EPOCHS,
                    outcome_epochs=OUTCOME_EPOCHS):
    """Phase 17: the host-against-device augmentation A/Bs on CARD: the
    distribution check (a), `torch_augment_ab` (b) and
    `torch_augment_outcome_ab` (c), each through its `main()`, with the
    launch counters read around every arm. Returns each kernel's launches
    over the phase."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    on_card = torch.device(CARD).type == "cuda"
    taa, tao = augment_ab_scripts()
    counters = _launch_counters()
    totals = dict.fromkeys(counters, 0)
    res = {"card": nvidia_smi() if on_card else None, "wall_s": {}}

    t0 = time.perf_counter()
    res["distribution"], n = augeq_on_card(counters)
    _add(totals, n)
    res["wall_s"]["distribution"] = time.perf_counter() - t0

    saved_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp, torch_default_tf32():
        tempfile.tempdir = tmp  # the scripts' own temporary directories
        try:
            dev = ["--device", "cuda" if on_card else "cpu"]
            t0 = time.perf_counter()
            results, arms = counted_arms(
                taa, "run_arm", "detect",
                ["--which", "both", "--epochs", str(ab_epochs)] + dev,
                counters)
            res["wall_s"]["augment_ab"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            report, oarms = counted_arms(
                tao, "run_one", "evaluate_checkpoint",
                ["--epochs", str(outcome_epochs), "--out",
                 str(Path(tmp) / "out")] + dev, counters)
            res["wall_s"]["outcome_ab"] = time.perf_counter() - t0
        finally:
            tempfile.tempdir = saved_tmp

    if [arm["result"] for arm in arms] != results:
        raise AssertionError("torch_augment_ab: arms and results differ")
    no_aug = max(2, ab_epochs // 5)
    res["augment_ab"] = []
    for arm in arms:
        r, n = arm["result"], arm["launches"]
        _add(totals, n)
        check_ab_iterations(
            f"augment_ab {'dev' if r['dev'] else 'host'}", arm["records"],
            aug_steps(ab_epochs, no_aug, 4) if r["dev"] else 0, on_card)
        images = taa.images_trained(ab_epochs)
        res["augment_ab"].append({
            **r, "img_s": images / max(r["wall_s"], 1e-9), "images": images,
            "launches": n, "detect_launches": arm["inner"],
            "aug_steps": sum(it["aug"] for it in arm["records"])})
        if on_card and not arm["inner"]["nms"] >= 1:
            raise AssertionError(f"augment_ab: no K2 launch in {r}")
        if not (r["run_avg_loss"] < AB_LOSS_MAX
                and r["confident_correct"] >= 1):
            raise AssertionError(f"augment_ab arm outside JAX's bounds: {r}")
    host, dev = (arm["result"] for arm in arms)
    gap = abs(host["run_avg_loss"] - dev["run_avg_loss"]) \
        / host["run_avg_loss"]
    res["loss_gap"] = gap
    if not gap < AB_LOSS_GAP:
        raise AssertionError(f"augment_ab relative loss gap {gap:.4f}")

    no_aug = max(outcome_epochs // 10, 1)
    res["outcome_ab"] = {**report, "arms": []}
    for arm in oarms:
        r, n = arm["result"], arm["launches"]
        _add(totals, n)
        check_ab_iterations(
            f"outcome_ab {r['device_augment']}", arm["records"],
            aug_steps(outcome_epochs, no_aug, 3) if r["device_augment"]
            else 0, on_card)
        # trained: before the L1 loss joins, the mean loss of the last
        # 10 iterations below that of the first 10
        losses = [it["loss"] for it in arm["records"] if not it["l1"]]
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        res["outcome_ab"]["arms"].append({
            "device_augment": r["device_augment"], "launches": n,
            "evaluation_launches": arm["inner"],
            "first_10_loss": first, "last_10_loss_before_l1": last,
            "aug_steps": sum(it["aug"] for it in arm["records"])})
        if on_card and not arm["inner"]["nms"] >= 1:
            raise AssertionError(f"outcome_ab: no K2 launch in {r}")
        if not (np.isfinite(r["final_loss"]) and last < first):
            raise AssertionError(f"outcome_ab arm did not train: loss "
                                 f"{first} -> {last}, {r}")
    if on_card:
        missing = [k for k in ("nms", "shear_xy") if not totals[k]]
        if missing:
            raise AssertionError(f"phase 17 launched no {missing}")
    res["launches"] = totals
    res["wall_s"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 17 (augmentation A/Bs) wall: {res['wall_s']['phase']:.1f} "
        f"s; card: {res['card']}")
    lines.append({"augment_abs": res})
    return totals


# ----------------------------------------------------- the model zoo (18)

# yolox-tiny, -m, -l and -x, the JAX package's other YOLOX models, at full
# width and depth from seeded weights: (config, weight seed, image size,
# serve batch, train batch). The sizes are the configs' test sizes, the
# batches `bench.py`'s SERVE_BATCH / TRAIN_BATCH (bench.py:50-53).
ZOO_MODELS = (("yolox_tiny", 4401, 416, 256, 64),
              ("yolox_m", 4402, 640, 128, 48),
              ("yolox_l", 4403, 640, 96, 32),
              ("yolox_x", 4404, 640, 32, 16))
ZOO_CHECK_B = (1, 2)     # `Yolox.__call__` batches held to the CPU
ZOO_INT8_B = 32          # int8 HBM serving from the bf16 module
ZOO_PARITY_B = 2         # the fused step against autograd, SimOTA held
ZOO_KERNEL_B = 8         # K3 / K4 against their plain versions
ZOO_AUG_B = 8            # tiny's device-augmented step
ZOO_STEPS = 3            # timed bf16 training steps after one warm-up
ZOO_LATENCY_REPS = 5     # timed b1 serve calls
ZOO_BATCH_REPS = 2       # timed serve-batch calls
# yolox-tiny's augmentation (`YoloxTiny`: mosaic scale 0.5-1.5, no MixUp)
ZOO_AUGMENT = {"scales": (0.5, 1.5), "enable_mixup": False}
# bf16 serving against the card's float32 serving (phase 9's bf16
# tolerances): a row matches one of the same class at IoU >= 0.9 and score
# within 10%; rows scoring within ZOO_BF16_NEAR (relative) of the
# threshold may go unpaired, since a 10% score move takes them across it
ZOO_BF16_NEAR = 0.1
# the fused step against autograd (`zoo_train`): float32 rounding grows
# through these deeper models' train-mode BN layers past phase 7's
# TRAIN_TOL (yolox-x at 128 px, B 2, on the CPU: fused and autograd float32
# gradients at 3.4 and 4.2 of it from the float64 step, which the fused
# float64 step meets at 1.4e-5), so the float64 autograd step is the
# arbiter: the fused float32 gradients (losses) within TRAIN_TOL
# (TRAIN_LOSS_RTOL) of it, or no further from it than ZOO_F32_SLACK times
# autograd's float32 gradients (losses)
ZOO_F32_SLACK = 2.0
# K3 and K4 in the profile of a training step (the kernels of
# `csrc/conv_bwd.cu`; PyTorch's reductions are `at::native::reduce_kernel`)
K4_KERNELS = ("grad_z_kernel", "products_bf16", "dgrad_f32", "wgrad_f32",
              "sum_splits")


def _check_launches(what, got, want):
    if got != want:
        raise AssertionError(f"{what} launched {got}, want {want}")
    log(f"{what}: launches {got}")


def bf16_rows_match(got, want, thr):
    """Detections of two runs, per image rows (box, score, 1, label), at
    phase 9's bf16 tolerances both ways (`bf16_match_fraction`), rows
    scoring within ZOO_BF16_NEAR of the threshold `thr` left out. Returns
    (share of `want`'s rows matched, share of `got`'s, rows compared)."""
    lim = thr * (1 + ZOO_BF16_NEAR)

    def firm(rows):
        return {i: r[r[:, 4] >= lim] for i, r in enumerate(rows)}

    g, w = firm(got), firm(want)
    return (bf16_match_fraction(got=dict(enumerate(got)), want=w),
            bf16_match_fraction(got=dict(enumerate(want)), want=g),
            sum(map(len, w.values())) + sum(map(len, g.values())))


def zoo_serve(cfg, init, size, rng, counters, total):
    """`Yolox.__call__` on uint8 frames at each of ZOO_CHECK_B on CARD in
    float32 against the CPU module with the same weights (the seeded
    `init`, scores spread; threshold in a wide gap of the scores,
    `assert_detections_match`), the bf16 module's detections against the
    card's float32 ones (`bf16_rows_match`); the launch counters read
    around the card's calls (K1 and K2 once a call). Returns (result,
    card float32 module, card bf16 module, threshold)."""
    import copy

    import torch

    from yolox_tpu_torch import Yolox, YoloxProcessor

    frames = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for _ in range(max(ZOO_CHECK_B))]
    # the spread and the threshold from the card's float32 forward: the
    # CPU's scores differ by ~1e-6 relative, far inside a 1e-3 gap
    gpu_mod = spread_scores(copy.deepcopy(init).to(CARD), np.stack(frames))
    cpu_mod = copy.deepcopy(gpu_mod).to("cpu")
    gpu, cpu = (Yolox(m, YoloxProcessor(cfg)) for m in (gpu_mod, cpu_mod))
    thr, gap = mesh_threshold(anchor_scores(
        gpu_mod, gpu.processor(frames, dtype=np.uint8)))
    if gap < 1e-3:
        raise AssertionError(f"no score gap wide enough ({gap:.3g})")

    _zero(counters)
    got = {b: gpu(frames[:b], threshold=thr) for b in ZOO_CHECK_B}
    n = _count(counters)
    _check_launches(f"{cfg.name} float32 serve at B {ZOO_CHECK_B}", n,
                    _only(counters, stem=len(ZOO_CHECK_B),
                          nms=len(ZOO_CHECK_B)))
    _add(total, n)
    t0 = time.perf_counter()
    want = cpu(frames, threshold=thr)
    cpu_s = time.perf_counter() - t0
    for b, dets in got.items():
        assert_detections_match(dets, want[:b])
    n_dets = sum(len(d["labels"]) for d in want)
    if n_dets < INT8_MIN_DETS:
        raise AssertionError(f"{n_dets} detections prove little")

    bf_mod = copy.deepcopy(cpu_mod).cast_params(torch.bfloat16).to(CARD)
    del cpu_mod, cpu
    _zero(counters)
    bdets = Yolox(bf_mod, YoloxProcessor(cfg))(frames, threshold=thr)
    n = _count(counters)
    _check_launches(f"{cfg.name} bf16 serve", n,
                    _only(counters, stem=1, nms=1))
    _add(total, n)
    f32_rows = detections_as_rows(got[max(ZOO_CHECK_B)])
    frac = bf16_rows_match(detections_as_rows(bdets), f32_rows, thr)
    n_bf = sum(len(d["labels"]) for d in bdets)
    log(f"{cfg.name}: float32 serve on the card matches the CPU ({n_dets}"
        f" detections at {thr:.4f}, gap {gap:.3g}; the CPU's call {cpu_s:.1f}"
        f" s); bf16 {n_bf} detections, {frac[0]:.4f} of float32's and "
        f"{frac[1]:.4f} of its own matched ({frac[2]} rows)")
    if min(frac[:2]) < EVAL_BF16_MATCH:
        raise AssertionError(f"{cfg.name}: bf16 serve against float32: "
                             f"{frac}")
    return ({"threshold": thr, "gap": gap, "detections": n_dets,
             "bf16_detections": n_bf, "bf16_match": list(frac[:2]),
             "cpu_call_s": cpu_s}, gpu_mod, bf_mod, thr)


def zoo_serve_times(mods, size, serve_b, thr):
    """b1 latency and serve-batch throughput of each module of `mods`
    ({key: module}): a host uint8 batch in, detections copied to the host,
    CUDA events per call (median after 2 warm-up calls); the device ms of
    the calls queued on a batch already on the card (`queued_ms`); peak
    memory of the batch's calls."""
    import torch

    out = {}
    for key, mod in mods.items():
        for b, reps in sorted({1: ZOO_LATENCY_REPS,
                               serve_b: ZOO_BATCH_REPS}.items()):
            x = np.random.default_rng(b).integers(0, 256, (b, size, size, 3),
                                                  dtype=np.uint8)
            xd = torch.from_numpy(x).to(CARD)

            def call(x=x):
                dets, valid = mod.serve(x, conf_thre=thr, max_det=1024)
                dets.cpu(), valid.cpu()

            torch.cuda.reset_peak_memory_stats()
            samples = _event_ms(call, reps)
            med = float(np.median(samples))
            t = {"B": b, "events_ms": med, "img_per_s": 1e3 * b / med,
                 "samples_ms": samples,
                 "device_ms": queued_ms(lambda: mod.serve(
                     xd, conf_thre=thr, max_det=1024), min(reps, 3)),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            t["device_img_per_s"] = 1e3 * b / t["device_ms"]
            out[f"{key}_b{b}"] = t
            log(f"serve {key} B {b}: {t}")
            del xd
    torch.cuda.empty_cache()
    return out


def zoo_stem(rng, module, size, serve_b):
    """K1 at the model's stem width against its plain version (uint8
    images to float32 and bf16, B 1 and the serve batch, `stem_limit`),
    then its times at those batches (`stem_times`: CUDA events, device ms,
    plain ms, `stem_bound`, the cuDNN yardstick). Returns ({case: times
    and "of_tolerance"}, channels, max float32 error)."""
    import torch

    from yolox_tpu_torch.models.blocks import fold_focus_weight

    focus = module.backbone.backbone.stem
    wb = fold_focus_weight(focus.conv.conv.weight.float()).contiguous()
    c = wb.shape[0]
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(
        np.float32)).to(CARD)
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(
        CARD)
    batches = sorted({1, serve_b})
    rel, err = {}, 0.0
    for b in batches:
        img = torch.from_numpy(rng.integers(0, 256, (b, size, size, 3),
                                            dtype=np.uint8)).to(CARD)
        for dt in (torch.float32, torch.bfloat16):
            w = wb if dt == torch.float32 else wb.bfloat16().float()
            e, r, r0 = check_stem(img, w, scale, bias, "silu", dt)
            key = f"b{b}" + ("" if dt == torch.float32 else "_bf16")
            rel[key] = r
            if dt == torch.float32:
                err = max(err, e)
            log(f"K1 C{c} {key} uint8 -> {dt} matches its plain version: "
                f"max |d| {e:.3g}, {r:.3g} of its tolerance ({r0:.3g} "
                "without the tensor-core term)")
        del img
    times = stem_times(rng, wb, scale, bias, size, batches)
    return ({k: {**t, "of_tolerance": rel[k]} for k, t in times.items()},
            c, err)


def zoo_q1_times(calls):
    """Q1 over the launches of one serve call (`capture_int8_convs`): the
    replay's ms (CUDA events) and device ms alone (`queued_ms`), the plain
    versions' ms, the summed `int8_conv_bound` and cuDNN's bf16 conv of
    each shape replayed alike (`int8_conv_times`' yardstick, lighter)."""
    import collections

    import torch
    import torch.nn.functional as F

    from yolox_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain

    def library(args):
        x, w, _, _, k, stride = args[:6]
        xb = x.to(torch.bfloat16)
        wb = torch.ones((w.shape[0], x.shape[1], k, k), dtype=torch.bfloat16,
                        device=x.device).contiguous(
                            memory_format=torch.channels_last)
        return lambda: F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2)

    def bound(args):
        b, cin, cout, h, w, k, stride, _ = _conv_key(0, args)
        out_bytes = 1 if args[8] is not None else (
            2 if args[7] == torch.bfloat16 else 4)
        return int8_conv_bound(b, h, w, cin, cout, k, stride, 1, out_bytes)

    libs = [library(a) for _, a in calls]

    def replay():
        for _, a in calls:
            int8_conv(*a)

    def replay_library():
        for f in libs:
            f()

    t = {"launches": len(calls), "ms": cuda_ms(replay, 2, warmup=1),
         "device_ms": queued_ms(replay, 2),
         "plain_ms": cuda_ms(lambda: [int8_conv_plain(*a) for _, a in calls],
                             1, warmup=0),
         "bound_ms": sum(bound(a)[0] for _, a in calls),
         "library_ms": cuda_ms(replay_library, 2, warmup=1),
         "library_device_ms": queued_ms(replay_library, 2),
         "shapes": len({_conv_key(0, a) for _, a in calls})}
    t["bound_by"] = collections.Counter(
        bound(a)[1] for _, a in calls).most_common(1)[0][0]
    return t


def zoo_int8(cfg, gpu_mod, bf_mod, size, thr, rng, counters, total):
    """int8 HBM serving at B ZOO_INT8_B from the bf16 module, with a table
    calibrated on the card (float32 module, 2 frames): Q1 against its
    plain version at every shape of `int8_conv_shapes(module, size,
    ZOO_INT8_B)` (`check_int8_conv`); one serve call with the launch
    counters read around it (Q1 once per BaseConv, K1 for the Focus stem,
    K2 once); the detections of its first image against the CPU's int8
    HBM serve of that frame (a bf16 module with the same weights and
    table) at phase 11's int8 tolerances (`match_int8_detections`);
    the share of the card's float32 detections that int8 keeps
    (`bf16_rows_match`'s tolerances, reported); Q1's times over that call
    (`zoo_q1_times`). Returns (result, Q1 max error)."""
    import copy

    import torch

    calib = torch.from_numpy(rng.integers(0, 256, (2, size, size, 3),
                                          dtype=np.uint8)).to(CARD)
    table = gpu_mod.calibrate_int8(calib)
    shapes = int8_conv_shapes(bf_mod, size, ZOO_INT8_B)
    n_q1 = sum(shapes.values())
    gen = torch.Generator(device=CARD).manual_seed(11)
    q1_err = q1_off = 0.0
    for b, cin, cout, h, w, k, stride, groups in sorted(shapes):
        x, w8, scale, bias, out_scale = q_inputs(gen, b, cin, cout, h, w, k)
        e, off = check_int8_conv(x, w8, scale, bias, k, stride, out_scale,
                                 False)
        q1_err, q1_off = max(q1_err, e), max(q1_off, off)
        del x, w8
    log(f"{cfg.name}: Q1 matches its plain version at the {len(shapes)} "
        f"distinct shapes of its {n_q1} int8 convs (B {ZOO_INT8_B}): "
        f"float32 max |d| {q1_err:.3g}, codes off by 1 {q1_off:.3g}")

    frames = rng.integers(0, 256, (ZOO_INT8_B, size, size, 3),
                          dtype=np.uint8)
    _zero(counters)
    dets, valid = bf_mod.serve(frames, conf_thre=thr, max_det=1024,
                               int8_hbm_qtab=table)
    n = _count(counters)
    # the HBM mode keeps the Focus stem float (K1); every BaseConv on Q1
    _check_launches(f"{cfg.name} int8 HBM serve at B {ZOO_INT8_B}", n,
                    _only(counters, int8_conv=n_q1 - 1, stem=1, nms=1))
    _add(total, n)

    def as_dets(dets, valid):
        """`serve`'s rows -> `Detections`-like dicts (score obj * cls)."""
        out = []
        for r, m in zip(dets.float().cpu().numpy(), valid.cpu().numpy()):
            r = r[m]
            out.append({"bboxes": r[:, :4], "scores": r[:, 4] * r[:, 5],
                        "labels": r[:, 6]})
        return out

    cpu_mod = copy.deepcopy(bf_mod).to("cpu")
    t0 = time.perf_counter()
    want = cpu_mod.serve(frames[:1], conf_thre=thr, max_det=1024,
                         int8_hbm_qtab={k: v.cpu() for k, v in table.items()})
    cpu_s = time.perf_counter() - t0
    del cpu_mod
    paired, flips, unpaired, box_d, score_d = match_int8_detections(
        as_dets(dets[:1], valid[:1]), as_dets(*want), thr)
    log(f"{cfg.name} int8 HBM, card (first of B {ZOO_INT8_B}) against "
        f"the CPU ({cpu_s:.1f} s): {paired} rows paired, {unpaired} within "
        f"{INT8_DET_SCORE_TOL} of the threshold unpaired, labels differ on "
        f"{flips}, box max |d| {box_d:.3g} px, score {score_d:.3g}")
    if paired < INT8_MIN_DETS or flips > INT8_LABEL_FLIPS * paired:
        raise AssertionError(f"{cfg.name} int8 HBM: {paired} rows paired, "
                             f"{flips} labels differ")
    fdets, fvalid = gpu_mod.serve(frames, conf_thre=thr, max_det=1024)
    keep = bf16_rows_match(detections_as_rows(as_dets(dets, valid)),
                           detections_as_rows(as_dets(fdets, fvalid)), thr)
    log(f"{cfg.name} int8 HBM against float32 on the card at B "
        f"{ZOO_INT8_B} (reported): {keep[0]:.4f} of float32's and "
        f"{keep[1]:.4f} of int8's detections matched")
    calls = capture_int8_convs(bf_mod, frames, thr, int8_hbm_qtab=table)
    q1 = zoo_q1_times(calls)
    log(f"{cfg.name} Q1 over one B {ZOO_INT8_B} HBM call: {q1}")
    del calls
    return ({"q1_shapes": len(shapes), "q1_launches": n_q1 - 1,
             "card_vs_cpu": {"paired": paired, "unpaired": unpaired,
                             "label_flips": flips, "box_max_abs_px": box_d,
                             "score_max_abs": score_d, "cpu_s": cpu_s},
             "float32_kept": list(keep[:2]), "q1": q1}, q1_err)


def conv_bwd_step_times(shapes, b):
    """K3 and K4 replayed over a bf16 step's launches (`shapes` in step
    order, B `b`) beside their library yardsticks replayed alike
    (`conv_bwd_calls`): the device ms of each replay (`queued_ms`: in a
    full run, after phase 16's traces, torch.profiler dropped up to 90% of
    such a replay's kernels on an H100), and the summed bounds
    (`conv_bwd_bounds`)."""
    import torch

    made, calls = {}, {"k3": [], "k4": [], "k3_lib": [], "k4_lib": []}
    bounds = {"k3": 0.0, "k4": 0.0}
    for i, (ci, co, h, w) in enumerate(shapes):
        if (ci, co, h, w) not in made:
            made[ci, co, h, w] = conv_bwd_calls(conv_bwd_case(
                300 + i, b, ci, co, h, w, torch.bfloat16, CARD))
        for k in calls:
            calls[k].append(made[ci, co, h, w][k])
        for k, (t_b, t_o) in conv_bwd_bounds(b, ci, co, h * w, 2,
                                             True).items():
            bounds[k] += max(t_b, t_o)
    out = {}
    for k in ("k3", "k4"):
        out[k] = {
            "device_ms": queued_ms(lambda: [f() for f in calls[k]], 3),
            "library_device_ms": queued_ms(
                lambda: [f() for f in calls[k + "_lib"]], 3),
            "bound_ms": bounds[k], "launches": len(shapes)}
    del made, calls
    torch.cuda.empty_cache()
    return out


def zoo_steps(cfg, init, size, b, rng, counters, total, n_convs):
    """1 + ZOO_STEPS bf16 `fused_bwd` steps at B `b` from the seeded
    `init`,
    the launch counters read around each (K3 and K4 once per 1x1 SiLU
    BaseConv, nothing else), losses finite; CUDA events of the timed
    steps, peak memory, and one step's kernels (`device_time`, K3's and
    K4's among them)."""
    import copy

    import torch

    from yolox_tpu_torch.core import init_train_state, make_train_step

    module = copy.deepcopy(init).to(CARD)
    state = init_train_state(module)
    step = make_train_step(module, cfg.num_classes,
                           compute_dtype=torch.bfloat16, fused_bwd=True)
    x = torch.from_numpy(rng.integers(0, 256, (b, size, size, 3),
                                      dtype=np.uint8)).to(CARD).float()
    labels = torch.from_numpy(synthetic_labels(rng, b, size)).to(CARD)
    want = _only(counters, reduce_sums=n_convs, main_1x1=n_convs)
    torch.cuda.reset_peak_memory_stats()
    samples, losses = [], {}
    for i in range(1 + ZOO_STEPS):
        torch.cuda.synchronize()
        _zero(counters)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, out = step(state, x, labels, 0.01)
        end.record()
        n = _count(counters)
        if n != want:
            raise AssertionError(f"a {cfg.name} step launched {n}, want "
                                 f"{want}")
        _add(total, n)
        losses = {k: float(v) for k, v in out.items()}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"a {cfg.name} step gave a non-finite "
                                 f"loss: {losses}")
        if i:
            samples.append(start.elapsed_time(end))
    med = float(np.median(samples))
    r = {"B": b, "median_ms": med, "img_per_s": 1e3 * b / med,
         "samples_ms": samples, "losses": losses,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": n}
    dev_ms, top = device_time(lambda: step(state, x, labels, 0.01), 1)
    r["kernels_ms"] = dev_ms
    r["k3_ms"] = sum(v for k, v in top if "reduce_kernel" in k
                     and "at::native" not in k)
    r["k4_ms"] = sum(v for k, v in top if any(n in k for n in K4_KERNELS))
    r["top"] = [(k[:60], round(v, 3)) for k, v in top[:6]]
    del module, state, step, x
    torch.cuda.empty_cache()
    return r


def zoo_train(cfg, init, size, train_b, rng, gpu_mod, counters, total):
    """K3 and K4 against their plain versions at every distinct 1x1 SiLU
    conv shape of the model (B ZOO_KERNEL_B, float32 and bf16, as phase
    6); the fused step against autograd at B ZOO_PARITY_B on one held
    SimOTA assignment (as phase 7, with the float64 autograd step as the
    arbiter: `ZOO_F32_SLACK`); bf16 training at B `train_b`
    (`zoo_steps`): a batch that does not fit in the card's memory is
    recorded and halved until one fits, and the phase says so; K3 / K4
    replayed over the step that ran (`conv_bwd_step_times`). Returns
    (result, the 1x1 shapes, K3 / K4 float32 max errors)."""
    import copy

    import torch

    shapes = kernel_conv_shapes(gpu_mod, size)
    errs, worst = {"k3": 0.0, "k4": 0.0}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (ci, co, h, w) in enumerate(sorted(set(shapes))):
            r = check_conv_bwd(conv_bwd_case(100 + i, ZOO_KERNEL_B, ci, co, h,
                                             w, dtype, CARD))
            for k in ("k3", "k4"):
                if dtype == torch.float32:
                    errs[k] = max(errs[k], r[k][0])
                worst[f"{k} {name}"] = max(worst.get(f"{k} {name}", 0.0),
                                           r[k][1])
    log(f"{cfg.name}: K3 / K4 match their plain versions at the "
        f"{len(set(shapes))} distinct shapes of its {len(shapes)} 1x1 SiLU "
        f"convs (B {ZOO_KERNEL_B}); worst error over tolerance "
        + json.dumps({k: round(v, 4) for k, v in worst.items()}))

    base = copy.deepcopy(init).to(CARD)
    xp = torch.from_numpy(rng.uniform(0, 255, (ZOO_PARITY_B, size, size, 3))
                          .astype(np.float32)).to(CARD)
    lp = torch.from_numpy(synthetic_labels(rng, ZOO_PARITY_B, size)).to(CARD)
    held = _assignment(base, xp, lp, cfg.num_classes)
    l_f, g_f, _ = _held_step(copy.deepcopy(base), xp, lp, held, True,
                             cfg.num_classes)
    l_a, g_a, _ = _held_step(copy.deepcopy(base), xp, lp, held, False,
                             cfg.num_classes)
    l_64, g_64, _ = _held_step(copy.deepcopy(base).double(), xp, lp, held,
                               False, cfg.num_classes, torch.float64)
    r_grad, r_loss = tensors_close(g_f, g_a, TRAIN_TOL), _losses_close(l_f,
                                                                       l_a)
    r_f, r_a = (tensors_close(g, g_64, TRAIN_TOL) for g in (g_f, g_a))
    q_f, q_a = (_losses_close(v, l_64) for v in (l_f, l_a))
    log(f"{cfg.name}: held assignment ({int(held['num_fg'].sum())} fg), "
        f"B {ZOO_PARITY_B}: fused against autograd, gradients at "
        f"{r_grad:.3g} and losses at {r_loss:.3g} of their tolerances; "
        f"against the float64 autograd step, gradients fused {r_f:.3g} "
        f"and autograd {r_a:.3g}, losses fused {q_f:.3g} and autograd "
        f"{q_a:.3g}")
    if r_f > max(1.0, ZOO_F32_SLACK * r_a) or \
            q_f > max(1.0, ZOO_F32_SLACK * q_a):
        raise AssertionError(f"{cfg.name}: the fused step's gradients "
                             "disagree with autograd's")
    del base, g_f, g_a, g_64

    b, oom = train_b, []
    while True:
        try:
            steps = zoo_steps(cfg, init, size, b, rng, counters, total,
                              len(shapes))
            break
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            oom.append(b)
            log(f"FINDING: {cfg.name} training at B {b} does not fit in "
                f"the card's memory; halving the batch")
            if b == 1:
                raise
            b //= 2
    log(f"{cfg.name} bf16 fused training at B {b}: {steps}")
    per_step = conv_bwd_step_times(shapes, b)
    log(f"{cfg.name} K3 / K4 over one B {b} step's launches: "
        f"{per_step}")
    return ({"kernel_convs": len(shapes), "distinct": len(set(shapes)),
             "kernel_checks_of_tolerance": worst,
             "parity": {"grad": r_grad, "loss": r_loss,
                        "fused_vs_float64": [r_f, q_f],
                        "autograd_vs_float64": [r_a, q_a]},
             "train_batch": train_b, "ran_batch": b, "oom_at": oom,
             "steps": steps, "k3_k4_per_step": per_step}, shapes, errs)


def zoo_augment(cfg, init, size, n_convs, rng, counters, total):
    """One device-augmented bf16 `fused_bwd` step of the model (B
    ZOO_AUG_B, ZOO_AUGMENT) with the launch counters read around it: K5
    once, K3 and K4 once per 1x1 SiLU conv; losses finite."""
    import copy

    import torch

    from yolox_tpu_torch.core import (
        init_train_state,
        make_augmented_train_step,
    )

    tiles, hw, labels = synthetic_tiles(rng, ZOO_AUG_B, size)
    args = [torch.from_numpy(a).to(CARD) for a in (tiles, hw, labels)]
    module = copy.deepcopy(init).to(CARD)
    state = init_train_state(module)
    step = make_augmented_train_step(
        module, cfg.num_classes, augment_kwargs=dict(ZOO_AUGMENT),
        compute_dtype=torch.bfloat16, fused_bwd=True)
    gen = torch.Generator(device=CARD).manual_seed(5)
    _zero(counters)
    state, out = step(state, *args, gen, 0.01, (size, size))
    n = _count(counters)
    _check_launches(f"{cfg.name} device-augmented step", n,
                    _only(counters, shear_xy=1, reduce_sums=n_convs,
                          main_1x1=n_convs))
    _add(total, n)
    losses = {k: float(v) for k, v in out.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"the augmented step gave {losses}")
    return {"B": ZOO_AUG_B, "losses": losses}


def run_zoo(lines, models=ZOO_MODELS):
    """Phase 18: yolox-tiny, -m, -l and -x at full width and depth on
    CARD (`zoo_serve`, `zoo_serve_times`, `zoo_stem`, `zoo_int8`,
    `zoo_train`; `zoo_augment` for tiny); one JSON line a model, with the
    card's name and power limit. Returns the launches of the phase's main
    paths by kernel."""
    import torch

    from yolox_tpu_torch import YoloxConfig, YoloxModule

    t0 = time.perf_counter()
    on_card = torch.device(CARD).type == "cuda"
    if on_card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi() if on_card else "cpu"
    counters = _launch_counters()
    total = dict.fromkeys(counters, 0)
    rng = np.random.default_rng(18)
    for name, seed, size, serve_b, train_b in models:
        t = time.perf_counter()
        cfg = YoloxConfig.get_named_config(name)
        cfg.test_size = (size, size)
        # the seeded weights, made once on the host; each module a copy
        init = YoloxModule.from_config(cfg, rng_seed=seed, device="cpu")
        serve, gpu_mod, bf_mod, thr = zoo_serve(cfg, init, size, rng,
                                                counters, total)
        times = zoo_serve_times({"float32": gpu_mod, "bfloat16": bf_mod},
                                size, serve_b, thr)
        stem, channels, stem_err = zoo_stem(rng, gpu_mod, size, serve_b)
        int8, q1_err = zoo_int8(cfg, gpu_mod, bf_mod, size, thr, rng,
                                counters, total)
        train, shapes, conv_errs = zoo_train(cfg, init, size, train_b, rng,
                                             gpu_mod, counters, total)
        del gpu_mod, bf_mod
        torch.cuda.empty_cache()
        aug = zoo_augment(cfg, init, size, len(shapes), rng, counters,
                          total) if name == "yolox_tiny" else None
        del init
        line = {"zoo": {
            "model": name, "card": card, "size": size, "seed": seed,
            "serve_batch": serve_b, "serve": serve, "serve_times": times,
            "stem": {"channels": channels, "max_abs_err": stem_err, **stem},
            "int8_hbm": {**int8, "max_abs_err": q1_err},
            "train": {**train, "max_abs_err": conv_errs},
            "augment": aug, "wall_s": time.perf_counter() - t}}
        lines.append(line)
        log(json.dumps(line))
    log(f"phase 18 (model zoo) wall: {time.perf_counter() - t0:.1f} s; "
        f"launches {total}; card: {card}")
    return total


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
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2024)

    walls, last = {}, [time.perf_counter()]

    def mark(name):
        """Note the wall seconds since the previous mark under `name`."""
        now = time.perf_counter()
        walls[name] = now - last[0]
        last[0] = now

    phase_start()
    mark("1 start")
    cfg = YoloxConfig.get_named_config("yolox_s")
    lines = []
    kernels = run_serve(cfg, rng, lines)
    mark("2-5 serve")
    eval_launches, eval_launches_bf16 = run_eval(cfg, rng, lines)
    mark("9 evaluation")
    for entry, key in ((kernels[0], "stem"), (kernels[1], "nms")):
        entry["launches_eval"] = eval_launches[key]
        entry["launches_eval_bf16"] = eval_launches_bf16[key]
    int8_kernels = run_int8(cfg, rng, lines)
    mark("11 int8")
    module = YoloxModule.from_config(cfg, rng_seed=4321)
    shapes = kernel_conv_shapes(module)
    log(f"{len(shapes)} 1x1 SiLU convs of yolox-s take K3 / K4: "
        + json.dumps(sorted(set(shapes))))
    if len(shapes) != 43:
        raise AssertionError("yolox-s has 43 1x1 SiLU BaseConvs")
    # every size phase 10's multiscale can draw
    sizes = [h for h, _ in trainer_multiscale(cfg).multiscale_sizes()
             if h != 640]
    multiscale = sorted(set().union(*(kernel_conv_shapes(module, s)
                                      for s in sizes)) - set(shapes))
    log(f"{len(multiscale)} distinct 1x1 shapes at {sizes} px: "
        + json.dumps(multiscale))
    del module
    kernels += run_train(cfg, rng, shapes, multiscale, lines)
    mark("6-7 training")
    kernels += run_augment(cfg, rng, len(shapes), lines)
    mark("8 augmentation")
    kernels += int8_kernels
    plain = next(line["train"] for line in lines if "train" in line)
    trainer_launches = run_trainer(
        cfg, len(shapes), plain["bfloat16_fused"].get("device_ms"), lines)
    mark("10 trainer")
    cli_launches = run_cli(cfg, rng, lines)
    mark("12 commands")
    parallel_launches = run_parallel(cfg, rng, len(shapes), lines)
    mark("13 parallel")
    mesh_launches = run_mesh(cfg, rng, lines)
    mark("14 meshes")
    harness_launches = run_harnesses(lines)
    mark("15 harnesses")
    profile_launches = run_profilers(len(shapes), lines)
    mark("16 profilers")
    ab_launches = run_augment_abs(lines)
    mark("17 augmentation A/Bs")
    zoo_launches = run_zoo(lines)
    mark("18 model zoo")
    for entry in kernels:
        key = {"stem_conv_bn_act": "stem", "nms_keep": "nms"}.get(
            entry["name"], entry["name"])
        entry["launches_trainer"] = trainer_launches[key]
        entry["launches_cli"] = cli_launches[key]
        entry["launches_parallel"] = parallel_launches[key]
        entry["launches_mesh"] = mesh_launches[key]
        entry["launches_harness"] = harness_launches[key]
        entry["launches_profile"] = profile_launches[key]
        entry["launches_ab"] = ab_launches[key]
        entry["launches_zoo"] = zoo_launches[key]
    for line in lines:
        log(json.dumps(line))
    log(json.dumps({"phase_wall_s": walls,
                    "total_s": sum(walls.values())}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
