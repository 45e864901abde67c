"""Offline batches: a batch job's letterboxed frames through
`YoloxModule.serve`, pipelined as `Yolox.stream` pipelines them.

Parameters (the cell's `traffic`):
  batch           images a call
  shapes          [[h, w, count], ...] of the frames in one batch (counts
                  sum to `batch`), each pasted top-left on the 114 canvas
                  of the input size, as the letterbox leaves a frame whose
                  long side is the target: the loader workers of a batch
                  job letterbox, so the window does not
  pool_batches    distinct host batches (uint8 NHWC, pageable), cycled
  warmup_calls    calls before the window
  serve           {"conf_thre", "nms_thre", "max_det"}: serve's arguments
  compare_extra   window batches compared besides the first call on each
                  pool batch, drawn from the seed

Each call is dispatched before the previous call's detections are fetched
to the host. `serve_img_per_s` counts the images whose detections reached
the host in the window, over the window's seconds; the window ends at the
first fetch after `seconds`. The last dispatched call is drained after the
window and compared, not counted.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
from torch.profiler import record_function

from perfbench import images, serving
from perfbench.trace import WINDOW


@dataclass
class Session:
    cell: dict
    seed: int
    device: object
    module: object
    state_host: dict
    pool: list
    serve: dict = field(default_factory=dict)


def setup(cell, seed, device) -> Session:
    config, p = cell["config"], cell["traffic"]
    state = serving.make_state(config, seed, device)
    module, _ = serving.build_module(config, state, device)
    state_host = {k: v.cpu() for k, v in state.items()}
    del state
    size = config["input_size"]
    shapes = images.shape_list(p["shapes"])
    if len(shapes) != p["batch"]:
        raise ValueError(f"shapes count {len(shapes)} != batch {p['batch']}")
    pool = []
    for j in range(p["pool_batches"]):
        frames = images.frames(shapes, seed + 100 + j, device)
        order = images.permutation(len(frames), seed + 100 + j)
        pool.append(np.stack([images.letterboxed(frames[i], size)
                              for i in order]))
    s = Session(cell, seed, device, module, state_host, pool, p["serve"])
    for _ in range(p["warmup_calls"]):
        d, v = _serve(s, pool[0])
        d.cpu(), v.cpu()
    return s


def _serve(s: Session, batch):
    return s.module.serve(batch, conf_thre=s.serve["conf_thre"],
                          nms_thre=s.serve["nms_thre"],
                          max_det=s.serve["max_det"])


def window(s: Session, seconds: float) -> dict:
    n_pool, b = len(s.pool), s.cell["traffic"]["batch"]
    rng = np.random.default_rng(s.seed)
    extra = set(rng.choice(np.arange(n_pool, 4 * n_pool + 64),
                           s.cell["traffic"]["compare_extra"],
                           replace=False).tolist())
    kept, done, i, pending = [], 0, 0, None
    with record_function(WINDOW):
        t0 = time.perf_counter()
        while True:
            with record_function("perfbench.serve"):
                dets, valid = _serve(s, s.pool[i % n_pool])
            if pending is not None:
                j, pd, pv = pending
                with record_function("perfbench.fetch"):
                    d, v = pd.cpu().numpy(), pv.cpu().numpy()
                done += b
                if j < n_pool or j in extra:
                    kept.append((j % n_pool, d, v))
                t_end = time.perf_counter()
                if t_end - t0 >= seconds:
                    break
            pending = (i, dets, valid)
            i += 1
    j, pd, pv = i, dets, valid
    d, v = pd.cpu().numpy(), pv.cpu().numpy()
    if j < n_pool or j in extra:
        kept.append((j % n_pool, d, v))
    elapsed = t_end - t0
    return {"metrics": {"serve_img_per_s": done / elapsed},
            "images": done, "calls": i + 1, "window_s": elapsed,
            "batch": b, "kept": kept, "attempted": done + b,
            "extra": {"calls": i + 1, "window_s": elapsed}}


def check(s: Session, win: dict) -> dict:
    s.module = None
    serving.free_program()
    b = win["batch"]
    images = [img for batch in s.pool for img in batch]
    programs = [[] for _ in images]
    for j, d, v in win["kept"]:
        for k, rows in enumerate(serving.rows_from_serve(d, v)):
            programs[j * b + k].append(rows)
    used = [i for i, p in enumerate(programs) if p]
    out = serving.reference_judge(s.cell, s.state_host,
                                  [images[i] for i in used],
                                  [programs[i] for i in used], s.device)
    out.update(attempted=win["attempted"], failed=0)
    return out


def control(s: Session) -> dict:
    """The control's numbers on the pool's images: the float8 reference in
    the program's place (`serving.control_rows`)."""
    s.module = None
    serving.free_program()
    images = [img for batch in s.pool for img in batch]
    ctl = serving.control_rows(s.cell, s.state_host, images, s.device)
    return serving.reference_judge(s.cell, s.state_host, images,
                                   [[rows] for rows in ctl], s.device)
