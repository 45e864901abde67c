#!/usr/bin/env python3
"""K2 before and after on one CUDA card: an earlier `csrc/nms.cu` of the
PyTorch port (one block an image, K <= 1024) against the current one
(`yolox_tpu_torch/ops/nms_kernel.py::nms_keep`), on the same inputs.

    git show <commit>:yolox_tpu_torch/csrc/nms.cu > _archive/nms_old.cu
    python3 scripts/torch_nms_ab.py --old-source _archive/nms_old.cu

(it uses `chip_smoke.py`'s helpers from the root of the repository).

1. prints both sources' registers and shared memory (`nvcc -Xptxas -v`);
2. holds the current kernel bit-equal to its plain version: K 1 to 8400
   with scattered and prefix valid masks, B up to 64, the ring forced to
   1, 8, 16 and 32 rows a chunk, each G (row tiles a block), the edge
   cases of `chip_smoke.nms_edge_cases`, and a repeat
   of one call;
3. times both kernels in turns (old, new, new, old) on the candidates
   yolox-s at 640 px hands K2 (`chip_smoke.NMS_CASES`: serving at B 1 and
   32, evaluation at B 1 and 32 with K 1024, K 2048 to 8400): device ms
   (`chip_smoke.queued_ms`), event ms (`chip_smoke.cuda_ms`), the old
   kernel's keep masks against the new ones, the plain version's ms, the
   bound (`chip_smoke.nms_bound`) and the walk floor
   (`chip_smoke.walk_floor_ms`);
4. the wrapper's host microseconds a call and their parts, the device
   time of timing builds that leave out the IoU tiles or the walk, for
   each G, and of builds with each register budget (1 to 4 blocks an SM
   in `__launch_bounds__`). A timing build compiles a copy of
   `csrc/nms.cu` with one statement edited (`variant_source`).

Prints one JSON line a case and writes all of them to --out. Exits
non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def ptxas(src: Path, out: Path) -> str:
    from yolox_tpu_torch.ops import _build

    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return "\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                     if "registers" in line or "Function properties" in line
                     or "Compiling entry" in line)


def old_launcher(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    f = lib.yolox_nms_keep
    f.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P, P, P, I, I, ctypes.c_float, P]
    return f


def check_current(rng):
    import torch

    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    failures = []

    def check(name, boxes, valid, thr, rows=None, group=None):
        got = nms_keep(boxes, valid, thr, rows, group)
        ok = torch.equal(got, nms_keep_plain(boxes, valid, thr))
        torch.cuda.synchronize()
        cs.log(f"K2 {name} thr {thr}: kept {int(got.sum())} of "
               f"{int(valid.sum())}, bit-equal {ok}")
        if not ok:
            failures.append(f"{name} thr {thr}")
        return got

    for k, b in ((1, 4), (37, 4), (1024, 64), (1025, 16), (2048, 8),
                 (4096, 4), (8400, 2)):
        boxes = torch.from_numpy(cs.random_boxes(rng, b, k, 50.0, 400.0)
                                 ).cuda()
        scattered = torch.from_numpy(rng.random((b, k)) > 0.2).cuda()
        prefix = torch.arange(k, device="cuda")[None] < torch.from_numpy(
            rng.integers(0, k + 1, (b, 1))).cuda()
        for vname, valid in (("scattered", scattered), ("prefix", prefix)):
            for thr in (0.3, 0.65):
                check(f"b{b} k{k} {vname}", boxes, valid, thr)
    for k, rows, group in ((1025, 1, 1), (1025, 8, 4), (1025, 32, 2),
                           (8400, 16, 4), (8400, 1, 1), (2048, None, 2)):
        boxes = torch.from_numpy(cs.random_boxes(rng, 2, k, 50.0, 400.0)
                                 ).cuda()
        valid = torch.from_numpy(rng.random((2, k)) > 0.1).cuda()
        check(f"k{k} ring rows {rows} G {group}", boxes, valid, 0.5, rows,
              group)
    eb, ev = (torch.from_numpy(a).cuda() for a in cs.nms_edge_cases())
    for thr in (0.0, 0.5, 0.65, 1.0):
        check("edge cases k128", eb, ev, thr)
    boxes = torch.from_numpy(cs.random_boxes(rng, 32, 1024)).cuda()
    valid = torch.ones((32, 1024), dtype=torch.bool, device="cuda")
    first = nms_keep(boxes, valid, 0.65)
    if not all(torch.equal(first, nms_keep(boxes, valid, 0.65))
               for _ in range(5)):
        failures.append("repeat")
    return failures


def launcher_args(boxes, valid, keep, group=None):
    """`nms_keep`'s packed launcher arguments, for calling a build of the
    launcher directly."""
    from yolox_tpu_torch.ops import _build
    from yolox_tpu_torch.ops import nms_kernel as nk

    b, k = valid.shape
    rest = nk._launch_args(boxes.device, _build.stream(boxes.device), b, k,
                           None, group)
    return nk._ARGS.pack(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                         *rest, 0.65)


def bind(lib_path: Path):
    from yolox_tpu_torch.ops import _build

    f = getattr(ctypes.CDLL(str(lib_path)), "yolox_nms_keep")
    f.restype = ctypes.c_int
    f.argtypes = _build.SIGNATURES["nms"]["yolox_nms_keep"]
    return f


def host_costs(case, calls=400):
    """Host microseconds a call of `nms_keep` and of its parts (the keep
    tensor, the ctypes launch alone), by the host clock over `calls`
    calls with a synchronize every 50."""
    import time

    import torch

    from yolox_tpu_torch.ops import _build
    from yolox_tpu_torch.ops import nms_kernel as nk

    boxes, valid = case
    b, k = valid.shape
    lib = _build.load("nms").yolox_nms_keep
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    args = launcher_args(boxes, valid, keep)
    parts = {
        "nms_keep": lambda: nk.nms_keep(boxes, valid, 0.65),
        "torch_empty_keep": lambda: torch.empty(
            (b, k), dtype=torch.bool, device=boxes.device),
        "ctypes_launch": lambda: _build.launch(lib, boxes.device, "nms",
                                               args),
    }
    out = {}
    for name, fn in parts.items():
        torch.cuda.synchronize()
        total = 0.0
        for i in range(calls):
            if i % 50 == 0:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        out[name] = 1e6 * total / calls
    torch.cuda.synchronize()
    return out


# The statements a timing build edits, each found exactly once in nms.cu
BOUNDS = "__launch_bounds__(THREADS, 4)"
TILES = "if (__syncthreads_or(rv != 0)) {"
WALK = "if (s_last) walk(a, b, smem);"


def variant_source(name, edits):
    """A copy of csrc/nms.cu under the build directory with each (old,
    new) of `edits` applied; raises if an `old` is not found once."""
    from yolox_tpu_torch.ops import _build

    src = (_build.CSRC / "nms.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"nms.cu: {old!r} is not found once")
        src = src.replace(old, new)
    path = _build.BUILD_DIR / f"nms_{name}.cu"
    path.write_text(src)
    return path


def build_variant(name, edits):
    """A build of an edited copy of csrc/nms.cu: (bound launcher,
    registers and stack lines of `-Xptxas -v`)."""
    from yolox_tpu_torch.ops import _build

    out = _build.BUILD_DIR / f"libnms_{name}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(variant_source(name, edits))], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    regs = [line.split(":", 1)[1].strip() for line in proc.stderr.splitlines()
            if "registers" in line]
    return bind(out), regs


def variant_times(cases):
    """Device ms of builds that let the kernel keep 1 to 4 blocks an SM
    (the register budget of `__launch_bounds__`), at the default G, with
    their registers."""
    import torch

    from yolox_tpu_torch.ops import _build

    res = {}
    for mb in (1, 2, 3, 4):
        f, regs = build_variant(
            f"min_blocks{mb}", [(BOUNDS, f"__launch_bounds__(THREADS, {mb})")])
        row = {"ptxas": regs}
        for name in ("serve_b1", "serve_b32", "eval_b1", "eval_b32",
                     "k8400_b1"):
            boxes, valid = cases[name]
            keep = torch.empty(valid.shape, dtype=torch.bool, device="cuda")
            args = launcher_args(boxes, valid, keep)
            row[name] = cs.queued_ms(
                lambda: _build.launch(f, boxes.device, "nms", args), 20)
        res[f"min_blocks_{mb}"] = row
    return res


def phase_times(cases):
    """Device ms of timing builds that leave out a phase (phases 1: the
    tiles only, 2: the walk only, 0: neither, the launch, tickets and
    valid words alone; the walk alone reads mask words no tile wrote)
    beside the full kernel (3), for each G (row tiles a block), at the
    serving and evaluation cases and K 8400."""
    import torch

    from yolox_tpu_torch.ops import _build

    no_tiles = (TILES, "if (__syncthreads_or(rv != 0) && false) {")
    no_walk = (WALK, "if (false) walk(a, b, smem);")
    libs = {}
    for phases, edits in ((0, [no_tiles, no_walk]), (1, [no_walk]),
                          (2, [no_tiles]), (3, [])):
        libs[phases] = build_variant(f"phases{phases}", edits)[0]
    res = {}
    for name in ("serve_b1", "serve_b32", "eval_b1", "eval_b32", "k8400_b1"):
        boxes, valid = cases[name]
        keep = torch.empty(valid.shape, dtype=torch.bool, device="cuda")
        res[name] = {}
        for g in (1, 2, 4):
            args = launcher_args(boxes, valid, keep, g)
            res[name].update({
                f"G{g} phases{ph}": cs.queued_ms(
                    lambda f=f: _build.launch(f, boxes.device, "nms", args),
                    20)
                for ph, f in libs.items()})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", required=True, type=Path)
    ap.add_argument("--out", type=Path,
                    default=REPO / "yolox_tpu_torch" / "_build" / "nms_ab.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_nms_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.ops import _build
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    cs.log("card:", cs.nvidia_smi())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    old_lib = _build.BUILD_DIR / "libnms_old_ab.so"
    cs.log("old kernel:\n" + ptxas(args.old_source, old_lib))
    cs.log("new kernel:\n" + ptxas(_build.CSRC / "nms.cu",
                                   _build.BUILD_DIR / "libnms_new_ab.so"))
    old = old_launcher(old_lib)

    rng = np.random.default_rng(6)
    failures = check_current(rng)

    module = YoloxModule.from_config(
        YoloxConfig.get_named_config("yolox_s"), rng_seed=4321)
    cs.spread_scores(module, np.random.default_rng(7).integers(
        0, 256, (2, 640, 640, 3), dtype=np.uint8))
    frames = rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
    threshold, _ = cs.gap_threshold(cs.anchor_scores(module, frames[:8]),
                                    0.25, 0.45)
    cases = cs.nms_cases(module, threshold, frames)
    del module
    torch.cuda.empty_cache()

    results = []
    for name, (boxes, valid) in cases.items():
        b, k = valid.shape
        keep_old = torch.empty((b, k), dtype=torch.uint8, device="cuda")

        def run_old(boxes=boxes, valid=valid, keep_old=keep_old):
            _build.check(old(boxes.data_ptr(), valid.data_ptr(),
                             keep_old.data_ptr(), b, k, 0.65,
                             _build.stream(boxes.device)), "old nms")

        def run_new(boxes=boxes, valid=valid):
            return nms_keep(boxes, valid, 0.65)

        old_runs = k <= 1024
        reading = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            if who == "old" and not old_runs:
                continue
            fn = run_old if who == "old" else run_new
            reading[who].append({"device_ms": cs.queued_ms(fn, 20),
                                 "ms": cs.cuda_ms(fn, 50)})
        new_keep = run_new()
        if old_runs:
            run_old()
            same = torch.equal(keep_old.view(torch.bool), new_keep)
            if not same:
                failures.append(f"{name}: old and new keep masks differ")
        plain_ms = None
        if b * k * k * 4 <= 2 << 30:
            plain_ms = cs.cuda_ms(lambda: nms_keep_plain(boxes, valid, 0.65),
                                  2, warmup=1)
        vnp = valid.cpu().numpy()
        bound_ms, bound_by = cs.nms_bound(vnp)
        floor_ms, walked = cs.walk_floor_ms(vnp)
        new_dev = float(np.mean([r["device_ms"] for r in reading["new"]]))
        row = {"case": name, "B": b, "K": k, "valid": int(vnp.sum()),
               "kept": int(new_keep.sum()), "walked": walked,
               "old": reading["old"] or "raises (K > 1024)",
               "new": reading["new"], "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "walk_floor_ms": floor_ms,
               "new_device_ms_per_walked_box": new_dev / max(walked, 1)}
        results.append(row)
        cs.log(json.dumps(row))
    host = host_costs(cases["serve_b1"])
    cs.log("host microseconds a call at serve_b1: " + json.dumps(host))
    phases = phase_times(cases)
    cs.log("device ms by phase (timing builds): " + json.dumps(phases))
    variants = variant_times(cases)
    cs.log("device ms by register budget: " + json.dumps(variants))
    card = cs.nvidia_smi()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "cases": results,
                                    "host_us": host, "phases": phases,
                                    "variants": variants,
                                    "failures": failures},
                                   indent=1))
    cs.log(card)
    if failures:
        cs.log("FAILED: " + "; ".join(failures))
        return 1
    cs.log("all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
