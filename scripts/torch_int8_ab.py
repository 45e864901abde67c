#!/usr/bin/env python3
"""Q1 / Q2 before and after on one CUDA card: an earlier
`csrc/int8_conv.cu` of the PyTorch port against the current one
(`yolox_tpu_torch/ops/int8_conv.py::int8_conv` / `int8_dwconv`), on the
launches of real int8 serve calls.

    git show <commit>:yolox_tpu_torch/csrc/int8_conv.cu \\
        > _archive/int8_conv_old.cu
    python3 scripts/torch_int8_ab.py --old-source _archive/int8_conv_old.cu

(the earlier source takes weights padded to 32 bytes and the launchers
`yolox_int8_conv(..., act, vec, stream)` / `yolox_int8_dwconv(..., act,
stream)`; it runs from the root of the repository and uses `chip_smoke`'s
helpers).

1. prints both sources' registers, spills and shared memory (`nvcc
   -Xptxas -v`);
2. captures the Q1 / Q2 launches of four serve calls: yolox-s (640 px,
   bf16 module, a table calibrated on the card) int8 ladder at B 32, int8
   HBM at B 32, the ladder at B 1, and nano (416 px) int8 HBM at B 32;
3. holds the epilogue's branch-free SiLU and requant bit-equal to the
   float64 SiLU and the IEEE-division requant on all 2^32 float inputs
   (`int8_conv.epilogue_mismatches`), and the current
   kernels, at every distinct launch, bit-equal to the
   earlier kernel's outputs and to their plain versions at
   `chip_smoke.check_int8_conv`'s tolerances (float32, bf16, requantized
   outputs and the exact sums), and to the launch's own arguments
   bit-equal to the earlier kernel;
4. times each call's launches replayed back to back (device ms,
   `chip_smoke.queued_ms`) in turns, old, new, new, old, with the bound
   (`chip_smoke.int8_conv_bound`) beside them; and per distinct shape of
   the B 32 calls;
5. with `--sweep`, times each distinct Q1 shape of the B 32 ladder call
   under every (BM, N, stages) the kernels are built for, beside the
   plan's choice;
6. with `--breakdown`, where Q1's time goes at four shapes of the ladder
   call (`PHASE_SHAPES`): timing builds of edited copies of the source,
   each with one phase guarded off (`VARIANTS`: the epilogue's stores,
   A's loads, B's loads, the MMAs), and one that stamps `%globaltimer`
   at each phase of every block (`STAMPED`: medians of the prologue,
   main loop, staging, epilogue and, for the window patch, the window's
   load; blocks resident an SM on average).

Prints one JSON line a case and writes them to --out. Exits non-zero if a
check fails or a current kernel is slower than the earlier one on a whole
call.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def ptxas(src: Path, out: Path) -> str:
    from yolox_tpu_torch.ops import _build

    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-Xptxas",
         "-v", "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    keep = []
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            keep.append(line.split("function '")[-1].split("'")[0][-60:])
        elif "registers" in line or "spill" in line:
            keep.append("  " + line.strip())
    return "\n".join(keep)


def old_library(src: Path):
    """Build `src` into `_build/` under a name of its own and bind its two
    launchers with their signatures."""
    from yolox_tpu_torch.ops import _build

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib_path = _build.BUILD_DIR / f"libint8_conv_old_{digest}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = ptxas(src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.yolox_int8_conv.argtypes = [P] * 6 + [I] * 10 + [P]
    lib.yolox_int8_dwconv.argtypes = [P] * 6 + [I] * 8 + [P]
    for f in (lib.yolox_int8_conv, lib.yolox_int8_dwconv):
        f.restype = I
    return lib, report


def old_weights(dw, args):
    """The launch's weights as the earlier kernel takes them: K padded to
    32 bytes."""
    import torch.nn.functional as F

    x, w, _, _, k = args[:5]
    if dw:
        return w
    kk = k * k * x.shape[1]
    return F.pad(w[:, :kk], (0, -(-kk // 32) * 32 - kk)).contiguous()


def old_runner(lib, dw, args):
    """A callable that runs the earlier kernel on the launch `args` (x, w,
    scale, bias, k, stride, act, out_dtype, out_scale) and returns its
    output."""
    import torch

    from yolox_tpu_torch.ops import _build
    from yolox_tpu_torch.ops.int8_conv import _ACT_CODES, _OUT_KINDS

    x, _, scale, bias, k, stride, act, out_dtype, out_scale = args
    x = x.contiguous(memory_format=torch.channels_last)
    w = old_weights(dw, args)
    b, c, h, wd = x.shape
    cout = c if dw else w.shape[0]
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    kind = 2 if out_scale is not None else _OUT_KINDS[out_dtype]
    dtype = torch.int8 if out_scale is not None else out_dtype
    osp = None if out_scale is None else out_scale.data_ptr()

    def run():
        out = torch.empty((b, ho, wo, cout), dtype=dtype,
                          device=x.device).permute(0, 3, 1, 2)
        head = (x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), osp, out.data_ptr(), kind, b, h, wd)
        if dw:
            err = lib.yolox_int8_dwconv(*head, c, k, stride, _ACT_CODES[act],
                                        _build.stream(x.device))
        else:
            vec = int(c % 16 == 0 and x.data_ptr() % 16 == 0)
            err = lib.yolox_int8_conv(*head, c, cout, k, stride,
                                      _ACT_CODES[act], vec,
                                      _build.stream(x.device))
        _build.check(err, "old Q2" if dw else "old Q1")
        return out
    return run


def new_runner(dw, args):
    from yolox_tpu_torch.ops.int8_conv import int8_conv, int8_dwconv

    f = int8_dwconv if dw else int8_conv
    return lambda: f(*args)


def serve_calls():
    """{call name: [(dw, args), ...]} of the four serve calls."""
    import torch

    from yolox_tpu_torch import YoloxConfig, YoloxModule

    rng = np.random.default_rng(7)
    calls = {}
    for name, cfg_name, size, seed, mode, b, bf16 in (
            ("yolox_s_ladder_b32", "yolox_s", 640, 4321, "ladder", 32, True),
            ("yolox_s_hbm_b32", "yolox_s", 640, 4321, "hbm", 32, True),
            ("yolox_s_ladder_b1", "yolox_s", 640, 4321, "ladder", 1, True),
            ("nano_hbm_b32", "yolox_nano", 416, 1234, "hbm", 32, False)):
        cfg = YoloxConfig.get_named_config(cfg_name)
        f32 = YoloxModule.from_config(cfg, rng_seed=seed)
        calib = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
        table = f32.calibrate_int8(torch.from_numpy(calib).cuda())
        mod = f32
        if bf16:
            mod = YoloxModule.from_config(cfg, rng_seed=seed,
                                          dtype=torch.bfloat16)
            mod.load_params(f32.state_dict())
        x = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
        kw = {"int8_qtab" if mode == "ladder" else "int8_hbm_qtab": table}
        calls[name] = cs.capture_int8_convs(mod, x, 1e-3, **kw)
        del mod, f32
    return calls


def check_launch(lib, dw, args):
    """The current kernel against the earlier one on the launch's own
    arguments (bit-equal) and against the plain version on the launch's
    codes and weights (`check_int8_conv`)."""
    import torch

    got, want = new_runner(dw, args)(), old_runner(lib, dw, args)()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        d = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{'Q2' if dw else 'Q1'} {cs._conv_key(dw, args)}"
                             f": old and new differ, max |d| {d}")
    x, w, scale, bias, k, stride = args[:6]
    out_scale = args[8] if args[8] is not None else torch.full_like(
        scale, 3 / 127)
    return cs.check_int8_conv(x, w, scale, bias, k, stride, out_scale,
                              bool(dw), args[6])


def time_call(lib, launches):
    """Device ms of the call's launches replayed back to back: old, new,
    new, old."""
    olds = [old_runner(lib, dw, a) for dw, a in launches]
    news = [new_runner(dw, a) for dw, a in launches]

    def replay(fns):
        return lambda: [f() for f in fns]

    t = [cs.queued_ms(replay(olds if i in (0, 3) else news), 3)
         for i in range(4)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
            "old": (t[0] + t[3]) / 2, "new": (t[1] + t[2]) / 2}


def bound_ms(dw, args):
    import torch

    b, cin, cout, h, w, k, stride, g = cs._conv_key(dw, args)
    ob = 1 if args[8] is not None else (2 if args[7] == torch.bfloat16
                                        else 4)
    return cs.int8_conv_bound(b, h, w, cin, cout, k, stride, g, ob)[0]


def sweep(launches):
    """Each distinct Q1 shape under every (BM, N, stages) the kernels are
    built for, by calling the launcher with that plan."""
    import torch

    from yolox_tpu_torch.ops import _build
    from yolox_tpu_torch.ops import int8_conv as q

    rows, seen = [], set()
    for dw, args in launches:
        key = cs._conv_key(dw, args)
        if dw or key in seen:
            continue
        seen.add(key)
        x, w, scale, bias, k, stride, act, out_dtype, out_scale = args
        x = x.contiguous(memory_format=torch.channels_last)
        b, cin, h, wd = x.shape
        cout = w.shape[0]
        plan = q.q1_plan(b, h, wd, cin, cout, k, stride,
                         x.data_ptr() % 16 == 0, q._sms(x.device))
        lib = q._library(x.device)
        times = {}
        for bm in (64, 128):
            for bn in q.Q1_PATCH_N if plan.patch else q.Q1_N:
                if bn > max(16, 2 * cout) or (plan.patch and bm != 128):
                    continue
                for stages in (3, 4):
                    window = plan.wr * plan.wc * cin if plan.patch else 0
                    smem = q.q1_smem(bm, bn, plan.bk, stages, window,
                                     plan.kp // plan.bk)
                    if smem > q.MAX_SMEM:
                        continue
                    tail = (int(plan.patch), bm, bn, plan.bk, stages,
                            plan.tc, smem)

                    def run():
                        return q._launch(lib.yolox_int8_conv, "Q1", x, w,
                                         scale, bias, k, stride, act,
                                         out_dtype, out_scale, cout,
                                         (cin, cout), tail)
                    times[f"{bm}x{bn}s{stages}"] = cs.queued_ms(run, 10)
        best = min(times, key=times.get)
        chosen = f"{plan.bm}x{plan.bn}s{plan.stages}"
        rows.append({"sweep": list(key), "plan": chosen,
                     "plan_ms": times.get(chosen), "best": best,
                     "best_ms": times[best], "all": times})
    return rows


# Timing builds: copies of csrc/int8_conv.cu with statements edited. A
# phase "guarded off" runs only under a condition the launch never meets
# (act < 0), so the compiler keeps the rest as it was.
OFF = "s.act < 0"
VARIANTS = {
    "no_epilogue": [("  switch (s.act * 3 + s.out_kind) {\n    Q1_STORE(0, 0)",
                     f"  if ({OFF}) switch (s.act * 3 + s.out_kind) {{\n"
                     "    Q1_STORE(0, 0)")],
    # the cp.async rows' loads of A
    "no_a_loads": [("          cp_async16(sa + swz(r * bk + col * 16, mask), "
                    "src, ok);",
                    f"          if ({OFF}) cp_async16(sa + swz(r * bk + col "
                    "* 16, mask), src, ok);")],
    "no_b_loads": [("      cp_async16(sb + swz(r * bk + c * 16, mask), src, "
                    "ok);",
                    f"      if ({OFF}) cp_async16(sb + swz(r * bk + c * 16, "
                    "mask), src, ok);")],
    "no_mma": [("      WgmmaS8<N>::mma(acc, da + 2 * st, db + 2 * st);",
                f"      if ({OFF}) WgmmaS8<N>::mma(acc, da + 2 * st, db + 2 "
                "* st);")],
}


def stamp(i):
    """Q1 source text: thread 0 of each block writes %globaltimer to
    stamp i of the block."""
    return ("  if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_stamps[blockIdx.y"
            f" * gridDim.x + blockIdx.x][{i}] = t_; }}\n")


# stamps: 0 start, 1 prologue issued, 2 main loop done, 3 sums staged,
# 4 stored; 5 the window patch's window loaded
STAMPED = [
    ("namespace {\n\nconstexpr int MAX_SMEM",
     "namespace {\n__device__ unsigned long long g_stamps[1 << 19][6];\n"
     "constexpr int MAX_SMEM"),
    ("  Tile tile{0, 0, 0, 0};\n", stamp(0) + "  Tile tile{0, 0, 0, 0};\n"),
    ("  for (int t = 0; t < D && t < nk; ++t) issue_a(t);\n",
     stamp(5) + "  for (int t = 0; t < D && t < nk; ++t) issue_a(t);\n"),
    ("  int acc[N / 2];\n", stamp(1) + "  int acc[N / 2];\n"),
    ("  // epilogue, first half", stamp(2) + "  // epilogue, first half"),
    ("  switch (s.act * 3 + s.out_kind) {\n    Q1_STORE(0, 0)",
     stamp(3) + "  switch (s.act * 3 + s.out_kind) {\n    Q1_STORE(0, 0)"),
    ("#undef Q1_STORE\n", "#undef Q1_STORE\n" + stamp(4)),
]
STAMPS_COPY = ('\nextern "C" int yolox_int8_stamps(void* host, int n) {\n'
               "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
               "      host, g_stamps, static_cast<size_t>(n) * 48));\n}\n")
# shapes of the breakdown (B, Cin, Cout, H, W, k, stride): the ladder's
# stem, its most frequent and its costliest 3x3 conv, a 1x1 conv
PHASE_SHAPES = ((32, 3, 32, 640, 640, 6, 2), (32, 128, 128, 40, 40, 3, 1),
                (32, 128, 128, 80, 80, 3, 1), (32, 64, 64, 160, 160, 1, 1))


def timing_builds(edits):
    """{name: library} of copies of csrc/int8_conv.cu with each name's
    (old, new) text edits, built in parallel into _build/."""
    from yolox_tpu_torch.ops import _build

    src = (_build.CSRC / "int8_conv.cu").read_text()
    procs = {}
    for name, reps in edits.items():
        text = src
        for a, b in reps:
            if a not in text:
                raise RuntimeError(f"timing build {name}: no {a[:50]!r}")
            text = text.replace(a, b, 1)
        if name == "stamped":
            text += STAMPS_COPY
        path = _build.BUILD_DIR / f"int8_conv_{name}.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        so = path.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"timing build {name} failed:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["int8_conv"].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = I, argtypes
        _build.check(lib.yolox_int8_init(), name)
        libs[name] = lib
    return libs


def breakdown():
    """Where Q1's time goes at PHASE_SHAPES (bf16 out, SiLU): device ms of
    builds with a phase guarded off, and block-phase medians (µs) from a
    build that stamps %globaltimer."""
    import torch

    from yolox_tpu_torch.ops import _build
    from yolox_tpu_torch.ops import int8_conv as q

    libs = timing_builds({"base": [], **VARIANTS, "stamped": STAMPED})
    libs["stamped"].yolox_int8_stamps.argtypes = [P, I]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for b, cin, cout, h, w, k, stride in PHASE_SHAPES:
        x, w8, scale, bias, _ = cs.q_inputs(gen, b, cin, cout, h, w, k)
        x = x.contiguous(memory_format=torch.channels_last)
        p = q.q1_plan(b, h, w, cin, cout, k, stride)
        tail = (int(p.patch), p.bm, p.bn, p.bk, p.stages, p.tc, p.smem)

        def run(lib, act="silu"):
            return q._launch(lib.yolox_int8_conv, "Q1", x, w8, scale, bias,
                             k, stride, act, torch.bfloat16, None, cout,
                             (cin, cout), tail)
        row = {"breakdown": [b, cin, cout, h, w, k, stride],
               "plan": f"{p.bm}x{p.bn}s{p.stages}"
                       f"{' patch' if p.patch else ''}",
               "relu_ms": cs.queued_ms(lambda: run(libs["base"], "relu"), 10)}
        for name, lib in libs.items():
            row[f"{name}_ms"] = cs.queued_ms(lambda: run(lib), 10)
        run(libs["stamped"])
        torch.cuda.synchronize()
        n = p.grid[0] * p.grid[1]
        st = np.zeros((n, 6), np.uint64)
        _build.check(libs["stamped"].yolox_int8_stamps(st.ctypes.data, n),
                     "stamps")
        t = st.astype(np.int64)
        dur = t[:, 4] - t[:, 0]
        span = t[:, 4].max() - t[:, 0].min()
        row["block_us"] = float(np.median(dur)) / 1e3
        for name, i, j in (("prologue", 0, 1), ("main_loop", 1, 2),
                           ("staging", 2, 3), ("epilogue", 3, 4)):
            row[f"{name}_us"] = float(np.median(t[:, j] - t[:, i])) / 1e3
        if p.patch:
            row["window_us"] = float(np.median(t[:, 5] - t[:, 0])) / 1e3
        row["blocks_an_sm"] = float(dur.sum() / span / 132)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", type=Path,
                    default=REPO / "_archive" / "int8_conv_old.cu")
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "int8_ab.jsonl")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_ab: no CUDA device", file=sys.stderr)
        return 1
    from yolox_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    cs.log("card:", cs.nvidia_smi())
    if not opts.old_source.exists():
        print(f"torch_int8_ab: {opts.old_source} is missing (git show "
              "<commit>:yolox_tpu_torch/csrc/int8_conv.cu > it)",
              file=sys.stderr)
        return 1
    lib, old_report = old_library(opts.old_source)
    new_report = ptxas(_build.CSRC / "int8_conv.cu",
                       _build.BUILD_DIR / "libint8_conv_ptxas.so")
    cs.log(f"old ({opts.old_source.name}):\n{old_report}\nnew:\n{new_report}")
    lines, failures = [], []
    from yolox_tpu_torch.ops.int8_conv import epilogue_mismatches

    n = epilogue_mismatches("cuda")
    lines.append({"epilogue_mismatches_of_2^32": n})
    cs.log(json.dumps(lines[-1]))
    if n:
        failures.append(f"the branch-free epilogue differs on {n} inputs")
    calls = serve_calls()
    shapes = {}
    for name, launches in calls.items():
        for dw, a in launches:
            shapes.setdefault(cs._conv_key(dw, a) + (dw, a[6]), (dw, a))
    for key, (dw, a) in sorted(shapes.items(), key=lambda kv: kv[0][:-1]):
        try:
            err, off = check_launch(lib, dw, a)
            lines.append({"check": list(key[:-2]), "q": "Q2" if dw else "Q1",
                          "f32_max_abs": err, "codes_off": off, "ok": True})
        except AssertionError as e:
            failures.append(str(e))
            lines.append({"check": list(key[:-2]), "ok": False,
                          "error": str(e)})
        cs.log(json.dumps(lines[-1]))
    for name, launches in calls.items():
        for q, dw in (("Q1", 0), ("Q2", 1)):
            sel = [c for c in launches if c[0] == dw]
            if not sel:
                continue
            t = time_call(lib, sel)
            t.update(call=name, q=q, launches=len(sel),
                     bound_ms=sum(bound_ms(*c) for c in sel))
            lines.append(t)
            cs.log(json.dumps(t))
            if t["new"] > t["old"]:
                failures.append(f"{name} {q}: new {t['new']:.4f} ms, old "
                                f"{t['old']:.4f}")
        if name.endswith("b32"):
            count = collections.Counter(cs._conv_key(dw, a)
                                        for dw, a in launches)
            first = {}
            for dw, a in launches:
                first.setdefault(cs._conv_key(dw, a), (dw, a))
            for key, (dw, a) in sorted(first.items()):
                t = time_call(lib, [(dw, a)])
                t.update(call=name, shape=list(key), count=count[key],
                         bound_ms=bound_ms(dw, a))
                lines.append(t)
                cs.log(json.dumps(t))
    if opts.breakdown:
        for row in breakdown():
            lines.append(row)
            cs.log(json.dumps(row))
    if opts.sweep:
        for row in sweep(calls["yolox_s_ladder_b32"]):
            lines.append(row)
            cs.log(json.dumps(row))
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    cs.log("card:", cs.nvidia_smi())
    if failures:
        cs.log("FAILED:\n" + "\n".join(failures))
        return 1
    cs.log("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
