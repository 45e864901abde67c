"""The port's spans (`utils/trace.py`) on the CPU: the serving path's seven
spans nested as they run, the client API's and the training step's in
their order, nothing recorded (and nothing exported) without a profiler,
and `launch_counts()` reading every hand kernel's counter.

Width 0.125, 64 px, under `torch.profiler.profile(activities=[CPU])`; the
yolov3 (Darknet-53) cases at its published widths, 64 px, and one of them
on the card (`cuda`).
"""

import importlib
import pkgutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolox_tpu_torch import YoloxConfig
from yolox_tpu_torch.core import init_train_state, make_train_step
from yolox_tpu_torch.models.processor import YoloxProcessor
from yolox_tpu_torch.models.yolox import Yolox, YoloxModule
from yolox_tpu_torch.ops.library import exported_ops
from yolox_tpu_torch.utils import trace
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

SIZE = 64
NUM_CLASSES = 3


def _cfg():
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width, cfg.num_classes = 0.125, NUM_CLASSES
    cfg.test_size = (SIZE, SIZE)
    return cfg


@pytest.fixture(scope="module")
def module():
    return YoloxModule.from_config(_cfg(), rng_seed=5, device="cpu")


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


def _spans(fn):
    """[(name, start, end, parent span's name)] of the port's spans that
    `fn()` records under a CPU profiler, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if not e.name.startswith("yolox."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("yolox."):
            parent = parent.cpu_parent
        out.append((e.name, e.time_range.start, e.time_range.end,
                    parent.name if parent is not None else None))
    return sorted(out, key=lambda s: s[1])


def test_span_names_are_one_list():
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(n.startswith("yolox.") for n in trace.SPANS)
    assert trace.SERVE_SPANS == ("yolox.serve", "yolox.h2d", "yolox.backbone",
                                 "yolox.k1", "yolox.head",
                                 "yolox.postprocess", "yolox.k2")


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = trace.span("yolox.serve"), trace.span("yolox.k1")
    assert first is second is trace.NULL
    with first:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("yolox.serve") is not trace.NULL


def test_serve_emits_the_seven_spans_nested(module):
    x = _frames(2)
    module.serve(x, conf_thre=0.0)
    spans = _spans(lambda: module.serve(x, conf_thre=0.0))
    assert [s[0] for s in spans] == list(trace.SERVE_SPANS)
    parent = {name: p for name, _, _, p in spans}
    assert parent == {"yolox.serve": None, "yolox.h2d": "yolox.serve",
                      "yolox.backbone": "yolox.serve",
                      "yolox.k1": "yolox.backbone",
                      "yolox.head": "yolox.serve",
                      "yolox.postprocess": "yolox.serve",
                      "yolox.k2": "yolox.postprocess"}
    # the serve call's children follow one another
    order = [s for s in spans if s[3] == "yolox.serve"]
    for (_, _, end, _), (_, start, _, _) in zip(order, order[1:]):
        assert end <= start


def test_meshed_serve_emits_the_serving_spans(module):
    """A one-process (1, 1) mesh: the meshed step records the same seven
    spans, K1 in the backbone and K2 in the postprocess."""
    from yolox_tpu_torch.parallel.mesh import serving_mesh

    fn = module.make_serving_fn(mesh=serving_mesh(1, 1), conf_thre=0.0)
    x = _frames(2, seed=4)
    fn(x)
    spans = _spans(lambda: fn(x))
    assert [s[0] for s in spans] == list(trace.SERVE_SPANS)
    parent = {name: p for name, _, _, p in spans}
    assert (parent["yolox.k1"], parent["yolox.k2"]) == (
        "yolox.backbone", "yolox.postprocess")


@pytest.mark.parametrize("profiling", [False, True])
def test_serving_fn_exports_the_same_operators(module, profiling):
    """The exported serving step holds K1 and K2 once each, as before the
    spans, and no profiler operator, traced with or without a profiler
    recording."""
    fn = module.make_serving_fn(conf_thre=0.0, max_det=32)
    x = torch.as_tensor(_frames(2, seed=1))
    fn(x)
    if profiling:
        with profile(activities=[ProfilerActivity.CPU]):
            program = torch.export.export(fn, (x,), strict=False)
    else:
        program = torch.export.export(fn, (x,), strict=False)
    assert exported_ops(program) == {"stem_conv_bn_act": 1, "nms_keep": 1,
                                     "int8_conv": 0, "int8_dwconv": 0}
    for node in program.graph_module.graph.nodes:
        assert "profiler" not in str(node.target)
        assert "record_function" not in str(node.target)
    with torch.inference_mode():
        got = program.module()(x)
    want = fn(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def yolov3():
    """The Darknet-53 detector at its published widths, 64 px: no Focus
    stem, so no K1."""
    from yolox_tpu_torch.config import Yolov3

    cfg = Yolov3()
    cfg.test_size = (SIZE, SIZE)
    return cfg.get_model(rng_seed=7, device="cpu")


def test_yolov3_serve_emits_the_serving_spans_without_k1(yolov3):
    """The Darknet path serves inside the same spans as the yolox cells:
    the copy, the backbone, the head and the postprocess (K2 in it) under
    `yolox.serve`, and no `yolox.k1`: its pixel conv is a plain conv."""
    x = _frames(2, seed=8)
    yolov3.serve(x, conf_thre=0.0)
    spans = _spans(lambda: yolov3.serve(x, conf_thre=0.0))
    assert [s[0] for s in spans] == [n for n in trace.SERVE_SPANS
                                     if n != "yolox.k1"]
    parent = {name: p for name, _, _, p in spans}
    assert parent == {"yolox.serve": None, "yolox.h2d": "yolox.serve",
                      "yolox.backbone": "yolox.serve",
                      "yolox.head": "yolox.serve",
                      "yolox.postprocess": "yolox.serve",
                      "yolox.k2": "yolox.postprocess"}


@pytest.mark.cuda
def test_yolov3_serve_launches_k2_and_no_k1_on_the_card():
    """On the card a bf16 yolov3 serve call of a uint8 batch launches K2
    once and K1 never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yolox_tpu_torch.config import Yolov3

    cfg = Yolov3()
    cfg.test_size = (SIZE, SIZE)
    model = cfg.get_model(rng_seed=7, device="cuda").cast_params(
        torch.bfloat16)
    x = _frames(4, seed=9)
    model.serve(x, conf_thre=0.0)
    torch.cuda.synchronize()
    before = trace.launch_counts()
    calls = 3
    for _ in range(calls):
        dets, valid = model.serve(x, conf_thre=0.0)
    torch.cuda.synchronize()
    after = trace.launch_counts()
    assert after["stem_conv_bn_act"] == before["stem_conv_bn_act"]
    assert after["nms_keep"] == before["nms_keep"] + calls
    assert dets.shape[0] == valid.shape[0] == 4


def test_client_spans_in_order(module):
    """`Yolox.stream` over two batches: each dispatch letterboxes and
    serves inside its span, and batch 1 is fetched after batch 2 is
    dispatched."""
    model = Yolox(module, YoloxProcessor(_cfg()))
    frames = list(_frames(4, seed=2))
    list(model.stream(frames, threshold=0.0, batch_size=2))
    spans = _spans(lambda: list(model.stream(frames, threshold=0.0,
                                             batch_size=2)))
    client = [(n, p) for n, _, _, p in spans if n in trace.CLIENT_SPANS
              or n == "yolox.serve"]
    one = [("yolox.dispatch", None), ("yolox.letterbox", "yolox.dispatch"),
           ("yolox.serve", "yolox.dispatch")]
    assert client == one + one + [("yolox.fetch", None)] * 2


def test_train_step_spans_in_order():
    module = YoloxModule.from_config(_cfg(), rng_seed=6, device="cpu")
    state = init_train_state(module)
    step = make_train_step(module, NUM_CLASSES)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((2, 4, 5), np.float32)
    labels[:, 0] = [1, 20, 24, 16, 20]
    labels[0, 1] = [2, 40, 36, 20, 12]
    spans = _spans(lambda: step(state, x, labels, 0.01))
    assert [s[0] for s in spans] == list(trace.TRAIN_SPANS)
    assert all(p is None for *_, p in spans)
    for (_, _, end, _), (_, start, _, _) in zip(spans, spans[1:]):
        assert end <= start


def test_launch_counts_lists_every_wrapper():
    """Every function of `yolox_tpu_torch/ops/` with a `.launches` counter
    is one of `launch_counts()`'s, under its own name."""
    import yolox_tpu_torch.ops as ops

    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"yolox_tpu_torch.ops.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches") \
                    and obj.__module__ == mod.__name__:
                found[name] = obj
    counts = trace.launch_counts()
    assert set(counts) == set(found)
    assert counts == {name: f.launches for name, f in found.items()}


def test_copy_counts_has_the_four_routes():
    counts = trace.copy_counts()
    assert set(counts) == {"staged", "staged_bytes", "pinned_direct",
                           "pageable"}
    assert all(isinstance(v, int) and v >= 0 for v in counts.values())
