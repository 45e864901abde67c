#!/usr/bin/env python3
"""The serving meshes over NCCL, one rank a card: the halo exchange's
point-to-point path (`halo.Transport.exchange`, `batch_isend_irecv`),
gathers over subgroups of more than one member
(`all_gather_into_tensor`) and the subgroups' first barriers, none of
which a one-card run reaches (`chip_smoke.py` phase 14 runs gloo ranks
sharing the card and NCCL only at world size 1).

    python3 scripts/torch_mesh_nccl.py [--ranks 4]   # one rank a card

It runs `chip_smoke.run_mesh` with the cases below on one rank a card:
yolox-s at full width and depth, 640 px, seeded weights with spread
scores, float32 (TF32 off) over (1, 4) b1, (2, 2) b2, (4, 1) b4 and
(1, 2) b1 (the last two ranks outside the mesh), bf16 over (1, 4) b1,
int8 HBM over (1, 4) b1 and the ladder over (2, 2) b2 (bf16 module, one
table calibrated on card 0), yolov3 over (1, 4) b1, nano int8 HBM at
416 px over (1, 4) (13 bands: 4, 3, 3, 3) and nano at 96 px over (1, 4)
(an empty rank). Each rank's `(dets, valid)` is held to one-process
`serve` on card 0 at the rank's own batch: whether bit-equal is printed,
and where not, it must agree at `chip_smoke.mesh_within`'s tolerances
(float32 at `assert_dets_match`'s, bf16 outputs row by row; cuDNN may
take another algorithm for a slab's shape), with one process's launches
(K2's alone on an empty rank); data splits are also held to one `serve`
of the whole batch (`chip_smoke.mesh_check`). For
the timed cases each rank prints the meshed b1 call's median wall ms
beside one process's on its own card, and the exchanges' counts, bytes
and host ms (NCCL enqueues them: the host ms is not the transfer time).
Needs as many cards as `--ranks` (default: every visible card; the cases
take 4). With `--out PATH` it also writes the results there as JSON;
the last line is one JSON object with `ok`. Exits non-zero if a check fails or with fewer than 4 cards.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

# (name, model, dtype, (n_data, n_space), batch, px, int8 mode)
CASES = (
    ("s_f32_1x4_b1", "yolox_s", "float32", (1, 4), 1, 640, None),
    ("s_f32_2x2_b2", "yolox_s", "float32", (2, 2), 2, 640, None),
    ("s_f32_4x1_b4", "yolox_s", "float32", (4, 1), 4, 640, None),
    ("s_f32_1x2_b1", "yolox_s", "float32", (1, 2), 1, 640, None),
    ("s_bf16_1x4_b1", "yolox_s", "bfloat16", (1, 4), 1, 640, None),
    ("s_hbm_1x4_b1", "yolox_s", "bfloat16", (1, 4), 1, 640, "hbm"),
    ("s_ladder_2x2_b2", "yolox_s", "bfloat16", (2, 2), 2, 640, "ladder"),
    ("v3_f32_1x4_b1", "yolov3", "float32", (1, 4), 1, 640, None),
    ("nano_hbm_1x4_416", "yolox_nano", "float32", (1, 4), 1, 416, "hbm"),
    ("nano_f32_1x4_96", "yolox_nano", "float32", (1, 4), 1, 96, None),
)
TIMED = ("s_f32_1x4_b1", "s_bf16_1x4_b1", "s_f32_1x2_b1")
RANKS = max(s[0] * s[1] for _, _, _, s, _, _, _ in CASES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks, one a card (default: every card)")
    ap.add_argument("--out", default=None,
                    help="also write the results here as JSON")
    args = ap.parse_args()
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = args.ranks or count
    if n < RANKS or count < n:
        print(f"torch_mesh_nccl: needs {RANKS} CUDA devices, found {count}",
              file=sys.stderr)
        return 1
    cs.CARD = "cuda:0"
    torch.cuda.set_device(0)
    cs.phase_start()  # the card, the versions and the kernel build
    t0 = time.perf_counter()
    lines = []
    launches = cs.run_mesh(None, np.random.default_rng(2024), lines, CASES,
                           TIMED, cards=[f"cuda:{r}" for r in range(n)],
                           backend="nccl", exact=False)
    res = lines[-1]["mesh"]
    res.update(launches=launches, script_s=time.perf_counter() - t0,
               device_count=count)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1, default=str))
    cs.log(f"launches over the ranks' checked meshed calls: "
           f"{json.dumps(launches)}")
    cs.log(res["card"])
    print(json.dumps({"ok": True, "backend": "nccl", "ranks": n,
                      "cards": res["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
