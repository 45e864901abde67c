"""`yolox-tpu-torch export` and the kernels' operators (`ops/library.py`)
on the CPU.

The exported programs carry K1, K2 and a float program's eval epilogues
(Q1 / Q2 with `--int8`) as `yolox_tpu_torch::` operator nodes, survive
`torch.export.save` / `load`, and reloaded equal the eager `forward` / `serve` of the same weights bit
for bit (on the CPU both run the kernels' plain versions). The operators'
fake implementations give the shapes, dtypes and strides of the real
outputs at every conv shape of nano and yolox-s width 0.125.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from yolox_tpu_torch import YoloxConfig
from yolox_tpu_torch.cli import main as torch_main
from yolox_tpu_torch.cli.export import load_program
from yolox_tpu_torch.models.yolox import YoloxModule
from yolox_tpu_torch.ops.library import exported_ops
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

SIZE = 64
# BaseConvs of a yolox-s forward past the stem: one eval epilogue each
BASE_CONVS = 73


def _cfg():
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width, cfg.num_classes = 0.125, 3
    cfg.test_size = (SIZE, SIZE)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A width-0.125 yolox-s checkpoint, its module, calibration images and
    a test batch."""
    from PIL import Image

    from yolox_tpu_torch.models.weights import save_pth_state_dict

    root = tmp_path_factory.mktemp("export")
    module = YoloxModule.from_config(_cfg(), rng_seed=11, device="cpu")
    save_pth_state_dict(module.state_dict(), root / "w.pth")
    rng = np.random.default_rng(4)
    paths = []
    for i, (h, w) in enumerate(((64, 64), (48, 80))):
        p = root / f"calib_{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    x = torch.as_tensor(rng.uniform(0, 255, (2, SIZE, SIZE, 3)),
                        dtype=torch.float32)
    return root, module, paths, x


def _export(root, name, *flags):
    out = str(root / f"{name}.pt2")
    rc = torch_main(["export", "-c", "yolox_s", "--ckpt", str(root / "w.pth"),
                     "--device", "cpu", "--batch-size", "2", "--tsize",
                     str(SIZE), "-D", "width=0.125", "-D", "num_classes=3",
                     "--output", out] + list(flags))
    return rc, out


def _counts(program):
    return {k: v for k, v in exported_ops(program).items() if v}


@pytest.mark.parametrize("kind", ["forward", "postprocess", "int8"])
def test_exported_program_equals_eager(setup, kind):
    from PIL import Image

    from yolox_tpu_torch.models.processor import YoloxProcessor

    root, module, paths, x = setup
    flags = {"forward": [],
             "postprocess": ["--include-postprocess", "--conf", "0.0",
                             "--max-det", "32"],
             "int8": ["--int8", "--calib-images"] + paths}[kind]
    rc, out = _export(root, kind, *flags)
    assert rc == 0
    assert (root / f"{kind}_weights.pth").exists()
    program = load_program(out)
    with torch.inference_mode():
        got = program.module()(x)
    if kind == "postprocess":
        want = module.serve(x, conf_thre=0.0, nms_thre=0.65, max_det=32)
        assert _counts(program) == {"stem_conv_bn_act": 1, "nms_keep": 1,
                                    "bn_act": BASE_CONVS}
        assert int(got[1].sum()) > 0
    elif kind == "forward":
        want = (module(x),)
        got = (got,)
        assert _counts(program) == {"stem_conv_bn_act": 1,
                                    "bn_act": BASE_CONVS}
    else:
        table = module.calibrate_int8(YoloxProcessor(_cfg())(
            [Image.open(p) for p in paths]))
        with torch.inference_mode():
            want = (module.forward_body(x, "ladder", table),)
        got = (got,)
        counts = _counts(program)
        assert set(counts) == {"int8_conv"} and counts["int8_conv"] > 50
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_export_no_decode_and_int8_without_images(setup):
    from yolox_tpu_torch.utils.demo_utils import demo_postprocess

    root, module, _, x = setup
    rc, out = _export(root, "raw", "--no-decode")
    assert rc == 0
    with torch.inference_mode():
        raw = load_program(out).module()(x)
    module.head.decode_in_inference = False
    try:
        want = module(x)
    finally:
        module.head.decode_in_inference = True
    assert torch.equal(raw, want)
    decoded = demo_postprocess(raw.numpy(), (SIZE, SIZE))
    np.testing.assert_allclose(decoded, module(x).numpy(), rtol=1e-5,
                               atol=1e-4)
    assert _export(root, "none", "--int8")[0] == 1


def test_serving_fn_export_int8_hbm_and_mesh(setup):
    """`make_serving_fn` with an int8-in-HBM table exports with Q1 and the
    stem, and is bit-equal to `serve` in memory; a meshed one (here a
    (1, 1) mesh, which needs no process group) refuses to be exported,
    by `export_program` and by `torch.export` alike."""
    from yolox_tpu_torch.cli.export import export_program
    from yolox_tpu_torch.parallel.mesh import serving_mesh

    _, module, _, x = setup
    table = module.calibrate_int8(x)
    fn = module.make_serving_fn(conf_thre=0.0, max_det=16,
                                int8_hbm_qtab=table)
    program = export_program(fn, x)
    counts = _counts(program)
    assert counts["stem_conv_bn_act"] == 1 and counts["nms_keep"] == 1
    assert counts["int8_conv"] > 50
    want = module.serve(x, conf_thre=0.0, max_det=16, int8_hbm_qtab=table)
    for g, w in zip(program.module()(x), want):
        assert torch.equal(g, w)
    meshed = module.make_serving_fn(mesh=serving_mesh(1, 1), conf_thre=0.0,
                                    max_det=16, int8_hbm_qtab=table)
    with pytest.raises(RuntimeError, match="meshed serving function runs "
                       "eagerly"):
        export_program(meshed, x)
    with pytest.raises(RuntimeError, match="meshed serving function runs "
                       "eagerly"), torch.no_grad():
        torch.export.export(meshed, (x,), strict=False)


def test_export_refuses_int8_weights_older_than_the_parameters(setup):
    """A parameter changed in place after the eager call that made the
    quantized weights makes the export raise instead of baking in stale
    weights; another eager call makes them anew and the export runs."""
    _, module, _, x = setup
    table = module.calibrate_int8(x)
    fn = module.make_serving_fn(conf_thre=0.0, max_det=16, int8_qtab=table)
    fn(x)
    with torch.no_grad():
        module.head.stems[0].conv.weight.mul_(1.0)
    with pytest.raises(RuntimeError, match="parameters changed"), \
            torch.no_grad():
        torch.export.export(fn, (x,), strict=False)
    fn(x)
    with torch.no_grad():
        program = torch.export.export(fn, (x,), strict=False)
    assert _counts(program)["int8_conv"] > 50


class _OpLog(TorchDispatchMode):
    """The names of the operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_wrappers_take_the_operator_only_while_exporting(monkeypatch):
    """Eager calls stay direct, and take the operator (defaults filled
    in) only while exporting; the operator runs the same body and its
    result equals the wrapper's."""
    from yolox_tpu_torch.ops import nms_kernel, stem

    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 255, (1, 8, 8, 3), generator=gen,
                      dtype=torch.uint8)
    wb = torch.randn(4, 3, 6, 6, generator=gen)
    scale, bias = torch.rand(4, generator=gen), torch.randn(4, generator=gen)
    calls = []
    plain = stem.stem_conv_bn_act_plain
    monkeypatch.setattr(stem, "stem_conv_bn_act_plain",
                        lambda *a: calls.append(1) or plain(*a))
    with _OpLog() as log:
        eager = stem.stem_conv_bn_act(x, wb, scale, bias)
    assert not any("yolox_tpu_torch" in n for n in log.names)
    op = torch.ops.yolox_tpu_torch.stem_conv_bn_act(x, wb, scale, bias,
                                                   "silu", torch.float32)
    assert torch.equal(eager, op) and len(calls) == 2
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    with _OpLog() as log:
        routed = stem.stem_conv_bn_act(x, wb, scale, bias)
    assert "yolox_tpu_torch.stem_conv_bn_act.default" in log.names
    assert torch.equal(routed, eager) and len(calls) == 3
    monkeypatch.undo()
    boxes = torch.rand(1, 16, 4, generator=gen) * 20
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 16, dtype=torch.bool)
    keep = torch.ops.yolox_tpu_torch.nms_keep(boxes, valid, 0.3)
    assert torch.equal(keep, nms_kernel.nms_keep(boxes, valid, 0.3))
    assert keep.data_ptr() != valid.data_ptr()


def _int8_calls(module, x, mode, monkeypatch):
    """Every Q1 / Q2 call (args, real output) of one int8 serve."""
    from yolox_tpu_torch.ops import quant

    calls = []
    original = quant.conv_int8

    def record(xq, qc, stride, act, out_dtype=torch.float32, out_scale=None):
        y = original(xq, qc, stride, act, out_dtype, out_scale)
        calls.append(((xq, qc.w, qc.scale, qc.bias, qc.ksize, stride, act,
                       out_dtype, out_scale), qc.groups, y))
        return y

    monkeypatch.setattr(quant, "conv_int8", record)
    table = module.calibrate_int8(x)
    module.serve(x, conf_thre=0.0, max_det=8,
                 **{f"int8_{'hbm_' if mode == 'hbm' else ''}qtab": table})
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("name", ["yolox_nano", "yolox_s"])
def test_fake_shapes_equal_real_outputs(name, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = YoloxConfig.get_named_config(name)
    if name == "yolox_s":
        cfg.width = 0.125
    cfg.num_classes = 3
    module = YoloxModule.from_config(cfg, rng_seed=1, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 255, (1, SIZE, SIZE, 3)), dtype=torch.float32)
    calls = []
    for mode in ("ladder", "hbm"):
        calls += _int8_calls(module, x, mode, monkeypatch)
    assert {groups > 1 for _, groups, _ in calls} == (
        {False, True} if name == "yolox_nano" else {False})
    fake = FakeTensorMode(allow_non_fake_inputs=False)
    seen = set()
    for args, groups, real in calls:
        op = (torch.ops.yolox_tpu_torch.int8_dwconv if groups > 1
              else torch.ops.yolox_tpu_torch.int8_conv)
        fargs = [fake.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with fake:
            out = op(*fargs)
        assert (out.shape, out.dtype, out.stride()) == (
            real.shape, real.dtype, real.stride())
        seen.add((groups > 1,) + tuple(args[0].shape) + tuple(args[4:6]))
    assert len(seen) > 10
    # K1 and K2 at the model's shapes
    scale, bias = module.backbone.backbone.stem.conv.bn_fold()
    wb = torch.zeros(scale.shape[0], 3, 6, 6)
    for dtype in (torch.float32, torch.bfloat16):
        real = torch.ops.yolox_tpu_torch.stem_conv_bn_act(
            x, wb, scale, bias, "silu", dtype)
        with fake:
            out = torch.ops.yolox_tpu_torch.stem_conv_bn_act(
                fake.from_tensor(x), fake.from_tensor(wb),
                fake.from_tensor(scale), fake.from_tensor(bias), "silu",
                dtype)
        assert (out.shape, out.dtype, out.stride()) == (
            real.shape, real.dtype, real.stride())
    boxes, valid = torch.rand(2, 84, 4), torch.ones(2, 84, dtype=torch.bool)
    with fake:
        out = torch.ops.yolox_tpu_torch.nms_keep(
            fake.from_tensor(boxes), fake.from_tensor(valid), 0.5)
    assert (out.shape, out.dtype) == ((2, 84), torch.bool)
