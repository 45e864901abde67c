"""The port's `yolox-tpu-torch` CLI (`yolox_tpu_torch/cli/`) on the CPU,
against the JAX package's `yolox-tpu` (`yolox_tpu/cli/`).

A tiny config addressed as `module:ClassName` in both packages (depth
0.33, width 0.125, 64 px, 3 classes) on the synthetic COCO set
(`conftest.coco_dir`); every port command runs in-process with
`--device cpu`. One JAX evaluation and one JAX `visualize` are the only
JAX graphs.

Tolerances: the evaluation's AP50:95 / AP50 within 1e-6 of JAX's (the
same weights, images and thresholds); demo detections equal to
`Yolox.__call__` on the same frames (same batch size, same module: no
tolerance); the assignment PNG pixel-equal to JAX's; `demo_postprocess`
equal to JAX's.
"""

import os
import textwrap

import numpy as np
import pytest
import torch

from yolox_tpu_torch.cli import main as torch_main
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

_CFG = """
class {cls}({base}):
    def __init__(self):
        super().__init__("tiny_cli")
        self.num_classes = 3
        self.depth, self.width = 0.33, 0.125
        self.input_size = self.test_size = (64, 64)
        self.data_dir = {coco!r}
        self.val_ann = "instances_train2017.json"
        self.data_num_workers = 0
        self.max_epoch = 1
        self.warmup_epochs = 1
        self.no_aug_epochs = 0
        self.eval_interval = 1
        self.print_interval = 1
        self.multiscale_range = 0
        self.save_history_ckpt = False
        self.lane_fold = False
        self.output_dir = {out!r}

    def get_eval_dataset(self, **kw):
        from {pkg}.data import CocoDataset, ValTransform
        return CocoDataset(
            data_dir=self.data_dir, json_file=self.val_ann,
            name="train2017", img_size=self.test_size,
            preproc=ValTransform())
"""


# the port's tiny config, recording in its run directory each rank's
# "rank/world" (ranks.txt) and which rank wrote each checkpoint
# (writes.txt)
_RANKS_CFG = """

class TorchTinyRanks(TorchTiny):
    def get_trainer(self, args):
        import os

        import torch.distributed as dist

        import yolox_tpu_torch.core.trainer as trainer

        rank, world = dist.get_rank(), dist.get_world_size()
        run = os.path.join(self.output_dir, args.name)
        os.makedirs(run, exist_ok=True)
        with open(os.path.join(run, "ranks.txt"), "a") as f:
            f.write(f"{rank}/{world}\\n")
        save = trainer.save_checkpoint

        def recording(state, is_best, save_dir, name=""):
            with open(os.path.join(run, "writes.txt"), "a") as f:
                f.write(f"{rank}\\n")
            return save(state, is_best, save_dir, name)

        trainer.save_checkpoint = recording
        return super().get_trainer(args)
"""


@pytest.fixture(scope="module")
def cfgs(coco_dir, tmp_path_factory):
    """(port config name, JAX config name, work dir): the same tiny config
    as a `module:ClassName` of each package."""
    root = tmp_path_factory.mktemp("cli")
    out = str(root / "out")
    text = "import yolox_tpu\nimport yolox_tpu_torch\n" + "".join(
        textwrap.dedent(_CFG).format(cls=cls, base=base, coco=coco_dir,
                                     out=out, pkg=pkg)
        for cls, base, pkg in (
            ("TorchTiny", "yolox_tpu_torch.YoloxConfig", "yolox_tpu_torch"),
            ("JaxTiny", "yolox_tpu.YoloxConfig", "yolox_tpu")))
    (root / "tiny_cli_cfg.py").write_text(text + _RANKS_CFG)
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(root))
    yield "tiny_cli_cfg:TorchTiny", "tiny_cli_cfg:JaxTiny", root
    mp.undo()


@pytest.fixture(scope="module")
def ckpt(cfgs):
    """A random-init port module saved with the port's `save_checkpoint`."""
    from yolox_tpu_torch.cli.utils import resolve_config
    from yolox_tpu_torch.models.yolox import YoloxModule
    from yolox_tpu_torch.utils.checkpoint import save_checkpoint

    name, _, root = cfgs
    module = YoloxModule.from_config(resolve_config(name), rng_seed=3,
                                     device="cpu")
    save_checkpoint({"model": module.state_dict(), "start_epoch": 1},
                    False, str(root), "m")
    return str(root / "m_ckpt.pth")


def _recording_eval(monkeypatch, config_cls):
    """Record what `config_cls.eval` returns."""
    got = []
    original = config_cls.eval

    def record(self, *a, **kw):
        out = original(self, *a, **kw)
        got.append(out)
        return out

    monkeypatch.setattr(config_cls, "eval", record)
    return got


# ---------------- parsers and configs ----------------

_PARSERS = ("train", "eval", "demo", "export", "visualize_assign")


def _argv_for(parser):
    """An argv that sets every option of `parser` to a non-default value."""
    argv = []
    for action in parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[-1]
        if action.nargs == 0:
            argv.append(flag)
        elif action.choices:
            argv += [flag, list(action.choices)[-1]]
        elif action.nargs == "+":
            argv += [flag, "a.jpg", "b.jpg"]
        elif action.type is int:
            argv += [flag, "3"]
        elif action.type is float:
            argv += [flag, "0.125"]
        elif action.dest == "opts":
            argv += [flag, "num_classes=5"]
        else:
            argv += [flag, "x"]
    for action in parser._actions:  # positionals
        if not action.option_strings and action.choices:
            argv.append(list(action.choices)[-1])
    return argv


@pytest.mark.parametrize("command", _PARSERS)
def test_parsers_accept_every_jax_flag(command):
    import importlib

    jax_mod = importlib.import_module(f"yolox_tpu.cli.{command}")
    torch_mod = importlib.import_module(f"yolox_tpu_torch.cli.{command}")
    jparser, tparser = jax_mod.make_parser(), torch_mod.make_parser()
    argv = _argv_for(jparser)
    want = vars(jparser.parse_args(argv))
    got = vars(tparser.parse_args(argv))
    assert got.pop("device") is None
    assert got == want
    jflags = {f for a in jparser._actions for f in a.option_strings}
    tflags = {f for a in tparser._actions for f in a.option_strings}
    assert tflags - jflags == {"--device"}
    assert not jflags - tflags
    assert vars(tparser.parse_args(argv + ["--device", "cpu"]))[
        "device"] == "cpu"


def test_help_lists_the_same_commands(capsys):
    from yolox_tpu.cli import main as jax_main

    assert torch_main(["--help"]) == 0
    out = capsys.readouterr().out
    assert jax_main(["--help"]) == 0
    jout = capsys.readouterr().out

    def commands(text):
        return [line.split()[0] for line in
                text.split("commands:")[1].splitlines()
                if line.startswith("  ") and not line.startswith("   ")]

    assert commands(out) == commands(jout) == [
        "train", "eval", "demo", "export", "visualize-assign"]
    assert torch_main(["nope"]) == 1


@pytest.mark.parametrize("name", ["yolox-s", "yolox_nano", "yolov3",
                                  "cfg"])
def test_resolve_config_and_opts_match_jax(cfgs, name):
    from yolox_tpu.cli import utils as jutils
    from yolox_tpu_torch.cli import utils as tutils

    tname, jname = (cfgs[0], cfgs[1]) if name == "cfg" else (name, name)
    opts = ["num_classes=7", "test_size=(96,128)", "nmsthre=0.5",
            "seed=3", "fused_conv_bwd=True", "simota_candidates=64"]
    tcfg, jcfg = tutils.resolve_config(tname), jutils.resolve_config(jname)
    tcfg.update(tutils.parse_model_config_opts(opts))
    jcfg.update(jutils.parse_model_config_opts(opts))
    for field in ("name", "num_classes", "depth", "width", "depthwise",
                  "act", "test_size", "input_size", "nmsthre", "seed",
                  "fused_conv_bwd", "simota_candidates", "test_conf",
                  "output_dir", "data_dir", "max_epoch"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    with pytest.raises(ValueError):
        tutils.resolve_config("no_such_model")
    with pytest.raises(ValueError):
        tutils.resolve_config("yolox_tpu_torch.config:validate_config")
    with pytest.raises(ValueError):
        tutils.parse_model_config_opts(["novalue"])


_URL = "tcp://localhost:1234"


@pytest.mark.parametrize("command,flags,want", [
    ("train", ["-d", "2"], (2, 2, 0)),
    ("train", ["--num_machines", "2", "--machine_rank", "1", "--dist-url",
               _URL], (1, 2, 1)),
    ("train", ["--dist-url", _URL], (1, 1, 0)),
    ("eval", ["-d", "4"], (4, 4, 0)),
    ("eval", ["--num_machines", "2", "--machine_rank", "1", "-d", "2",
              "--dist-url", _URL], (2, 4, 2)),
    ("eval", ["--dist-url", _URL], (1, 1, 0)),
])
def test_multi_process_flags_launch(cfgs, command, flags, want):
    """-d, --num_machines, --machine_rank and --dist-url make the launch
    plan: this machine's processes, the world size, the first rank; gloo
    with --device cpu; a free local port when one machine runs several
    processes without --dist-url."""
    import importlib

    from yolox_tpu_torch.cli.utils import launch_plan

    cmd = importlib.import_module(f"yolox_tpu_torch.cli.{command}")
    args = cmd.make_parser().parse_args(
        ["-c", cfgs[0], "--device", "cpu"] + flags)
    plan = launch_plan(args)
    assert (plan.nprocs, plan.world_size, plan.first_rank) == want
    assert plan.backend == "gloo"
    if "--dist-url" in flags:
        assert plan.dist_url == _URL
    else:
        assert plan.dist_url.startswith("tcp://127.0.0.1:")


def test_devices_flag_on_cuda(cfgs, monkeypatch):
    """On CUDA: -d defaults to every local card, one NCCL process each;
    more than the machine has raises; none and no -d is one process."""
    from yolox_tpu_torch.cli import train
    from yolox_tpu_torch.cli.utils import launch_plan

    parse = train.make_parser().parse_args
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    plan = launch_plan(parse(["-c", cfgs[0]]))
    assert (plan.nprocs, plan.world_size, plan.backend) == (4, 4, "nccl")
    with pytest.raises(ValueError, match="has 4 CUDA device"):
        launch_plan(parse(["-c", cfgs[0], "-d", "5"]))
    with pytest.raises(ValueError, match="needs --dist-url"):
        launch_plan(parse(["-c", cfgs[0], "--num_machines", "2"]))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert launch_plan(parse(["-c", cfgs[0]])).backend is None


def test_train_in_two_processes_on_the_cpu(cfgs, monkeypatch):
    """`train --device cpu -d 2 -b 4`: two gloo ranks of two images each
    train the epoch's 3 iterations and evaluate; rank 0 alone writes the
    checkpoints."""
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    name, _, root = cfgs
    monkeypatch.setenv("OMP_NUM_THREADS", str(max(
        1, tests._torch_threads.cpu_share() // 2)))
    assert torch_main(["train", "-c", "tiny_cli_cfg:TorchTinyRanks",
                       "--device", "cpu", "-d", "2", "-b", "4", "-n",
                       "dp_run"]) == 0
    out = root / "out" / "dp_run"
    writes = (out / "writes.txt").read_text().split()
    assert writes and set(writes) == {"0"}
    ranks = (out / "ranks.txt").read_text().split()
    assert sorted(ranks) == ["0/2", "1/2"]
    ckpt = load_checkpoint(str(out / "latest_ckpt.pth"))
    assert ckpt["start_epoch"] == 1
    assert "iter: 3/3" in (out / "train_log.txt").read_text()


def test_no_card_and_no_device_raises(cfgs, ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_main(["eval", "-c", cfgs[0], "--speed", "-b", "4"])


# ---------------- eval ----------------

def test_eval_matches_jax_eval_cli(cfgs, ckpt, monkeypatch):
    """`eval` on one `.pth` (the port's `save_checkpoint`, loaded strict
    by JAX's CLI): the same AP50:95 / AP50 as `yolox-tpu eval`."""
    import yolox_tpu
    import yolox_tpu_torch
    from yolox_tpu.cli import main as jax_main

    tname, jname, root = cfgs
    argv = ["-b", "4", "--ckpt", ckpt, "--conf", "0.001"]
    got = _recording_eval(monkeypatch, yolox_tpu_torch.YoloxConfig)
    want = _recording_eval(monkeypatch, yolox_tpu.YoloxConfig)
    assert torch_main(["eval", "-c", tname, "--device", "cpu"] + argv) == 0
    assert jax_main(["eval", "-c", jname] + argv) == 0
    (t_ap, t_ap50, _), = got
    (j_ap, j_ap50, _), = want
    assert abs(t_ap - j_ap) <= 1e-6 and abs(t_ap50 - j_ap50) <= 1e-6
    assert os.path.exists(root / "out" / "tiny_cli" / "eval_log.txt")


@pytest.mark.parametrize("mode", ["--int8", "--int8-hbm"])
def test_eval_int8_runs(cfgs, ckpt, mode, monkeypatch):
    import yolox_tpu_torch
    from yolox_tpu_torch.ops import quant

    got = _recording_eval(monkeypatch, yolox_tpu_torch.YoloxConfig)
    calls = []
    original = quant.conv_int8
    monkeypatch.setattr(quant, "conv_int8",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    assert torch_main(["eval", "-c", cfgs[0], "--device", "cpu", "-b", "4",
                       "--ckpt", ckpt, mode, "--calib-batches", "2",
                       "--fuse", "--conf", "0.001"]) == 0
    (ap, ap50, summary), = got
    assert 0.0 <= ap <= ap50 <= 1.0 and summary
    assert calls  # the int8 convs ran


# ---------------- train ----------------

def test_train_one_epoch_then_eval_its_checkpoint(cfgs, monkeypatch):
    import yolox_tpu_torch

    name, _, root = cfgs
    assert torch_main(["train", "-c", name, "-b", "4", "--device", "cpu",
                       "--seed", "7", "-n", "run"]) == 0
    ckpt = root / "out" / "run" / "latest_ckpt.pth"
    assert ckpt.exists()
    got = _recording_eval(monkeypatch, yolox_tpu_torch.YoloxConfig)
    assert torch_main(["eval", "-c", name, "--ckpt", str(ckpt), "--device",
                       "cpu", "-b", "4", "--conf", "0.001"]) == 0
    (ap, ap50, _), = got
    assert np.isfinite(ap) and np.isfinite(ap50)


# ---------------- demo ----------------

def _model(cfgs, ckpt):
    from yolox_tpu_torch.cli.utils import resolve_config
    from yolox_tpu_torch.models.processor import YoloxProcessor
    from yolox_tpu_torch.models.yolox import Yolox, YoloxModule
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = resolve_config(cfgs[0])
    module = YoloxModule.from_config(cfg, device="cpu")
    module.load_params(load_checkpoint(ckpt)["model"])
    return Yolox(module, YoloxProcessor(cfg))


def _demo(argv):
    from yolox_tpu_torch.cli import demo

    return demo.run(demo.make_parser().parse_args(argv))


@pytest.mark.parametrize("int8", [False, True])
def test_demo_images_equal_yolox_call(cfgs, ckpt, coco_dir, tmp_path, int8):
    from PIL import Image

    files = sorted((p for p in os.scandir(os.path.join(coco_dir,
                                                       "train2017"))),
                   key=lambda p: p.name)[:3]
    folder = tmp_path / "imgs"
    folder.mkdir()
    for f in files:
        os.symlink(f.path, folder / f.name)
    out = tmp_path / "vis"
    argv = ["image", "-c", cfgs[0], "--path", str(folder), "--ckpt", ckpt,
            "--conf", "1e-5", "--device", "cpu", "--save_result",
            "--output-dir", str(out)] + (["--int8"] if int8 else [])
    got = _demo(argv)
    model = _model(cfgs, ckpt)
    images = [Image.open(folder / f.name) for f in files]
    if int8:
        model.int8_qtab = model.module.calibrate_int8(
            model.processor(images[:1]))
    want = [model([im], threshold=1e-5)[0] for im in images]
    assert got == want
    assert sum(len(d["labels"]) for d in got) > 0
    assert sorted(os.listdir(out)) == [f.name for f in files]


def test_demo_video_equals_yolox_call(cfgs, ckpt, tmp_path):
    import cv2

    rng = np.random.default_rng(1)
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (80, 48))
    for _ in range(5):
        writer.write(rng.integers(0, 255, (48, 80, 3), dtype=np.uint8))
    writer.release()
    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame[:, :, ::-1]))
    cap.release()
    assert len(frames) == 5
    got = _demo(["video", "-c", cfgs[0], "--path", path, "--ckpt", ckpt,
                 "--conf", "1e-5", "--device", "cpu", "--batch", "2",
                 "--save_result", "--output-dir", str(tmp_path / "o")])
    model = _model(cfgs, ckpt)
    want = []
    for i in range(0, 5, 2):
        want += model(frames[i:i + 2], threshold=1e-5)
    assert got == want
    cap = cv2.VideoCapture(str(tmp_path / "o" / "clip.avi"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()


def test_demo_int8_without_a_frame_raises(cfgs, ckpt, tmp_path):
    empty = tmp_path / "empty.avi"
    empty.write_bytes(b"")
    with pytest.raises(RuntimeError, match="calibration frame"):
        _demo(["video", "-c", cfgs[0], "--path", str(empty), "--ckpt", ckpt,
               "--device", "cpu", "--int8"])


def test_demo_postprocess_matches_jax():
    from yolox_tpu.utils import demo_utils as jdemo
    from yolox_tpu_torch.utils import demo_utils as tdemo

    rng = np.random.default_rng(0)
    for size, strides, p6 in (((64, 64), (8, 16, 32), False),
                              ((128, 96), (8, 16, 32, 64), True)):
        a = sum((size[0] // s) * (size[1] // s) for s in strides)
        x = rng.normal(size=(2, a, 8)).astype(np.float32)
        np.testing.assert_array_equal(tdemo.demo_postprocess(x, size, p6),
                                      jdemo.demo_postprocess(x, size, p6))
    boxes = np.abs(rng.normal(size=(40, 4)) * 20).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2] + 1
    scores = rng.uniform(size=(40, 3)).astype(np.float32)
    for agnostic in (False, True):
        np.testing.assert_array_equal(
            tdemo.multiclass_nms(boxes, scores, 0.45, 0.3, agnostic),
            jdemo.multiclass_nms(boxes, scores, 0.45, 0.3, agnostic))


# ---------------- visualize ----------------

def test_visualize_equals_jax_and_keeps_state(cfgs, tmp_path):
    from PIL import Image

    from yolox_tpu.cli.utils import resolve_config as jresolve
    from yolox_tpu.models.yolox import YoloxModule as JModule
    from yolox_tpu_torch.cli.utils import resolve_config
    from yolox_tpu_torch.models.weights import state_dict_to_jax
    from yolox_tpu_torch.models.yolox import YoloxModule

    module = YoloxModule.from_config(resolve_config(cfgs[0]), rng_seed=5,
                                     device="cpu")
    jmod = JModule.from_config(jresolve(cfgs[1]))
    jmod.load_params(state_dict_to_jax(module.state_dict()))
    rng = np.random.default_rng(2)
    x = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.float32)
    targets = np.zeros((2, 6, 5), np.float32)
    targets[0, :2] = [[0, 20, 24, 16, 20], [2, 44, 40, 24, 18]]
    targets[1, :3] = [[1, 32, 32, 40, 40], [0, 12, 50, 14, 10],
                      [2, 50, 14, 12, 16]]
    before = {k: v.clone() for k, v in module.state_dict().items()}
    module.visualize(x, targets, save_prefix=str(tmp_path / "t_"))
    assert not module.training
    after = module.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    module.train()
    module.visualize(x, targets, save_prefix=str(tmp_path / "t_"))
    assert module.training
    jmod.visualize(x, targets, save_prefix=str(tmp_path / "j_"))
    for b in range(2):
        got = np.asarray(Image.open(tmp_path / f"t_{b}.png"))
        want = np.asarray(Image.open(tmp_path / f"j_{b}.png"))
        np.testing.assert_array_equal(got, want)
        assert (got != x[b].astype(np.uint8)[..., ::-1]).any()


def test_visualize_assign_cli(cfgs, tmp_path):
    out = tmp_path / "assign"
    assert torch_main(["visualize-assign", "-c", cfgs[0], "-b", "2",
                       "--device", "cpu", "--output-dir", str(out),
                       "-D", "input_size=(64,64)"]) == 0
    assert sorted(os.listdir(out)) == ["assign_vis_0_0.png",
                                       "assign_vis_0_1.png"]
