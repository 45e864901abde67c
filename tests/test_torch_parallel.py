"""The port's data parallelism (`yolox_tpu_torch/parallel/mesh.py`) on
the CPU: two gloo ranks spawned by `torch.multiprocessing`, a narrow model
(depth 0.33, width 0.125, 3 classes, 64 px), each rank on its share of the
threads.

- The data-parallel step against JAX's `make_train_step(mesh=
  data_parallel_mesh(2))` on the conftest's virtual CPU devices, float64,
  `fused_bwd` off and on: rank 0 and rank 1 step on DIFFERENT halves of
  the global batch (one with 5 boxes, one with 1 and an empty image), so
  a missing all-reduce of the gradients, the BN statistics or the losses
  shows. Parameters (as updates), momentum, EMA, BN statistics and the
  logged losses within the float64 allowance of `tests/test_torch_train.py`:
  1e-6 of each tensor's
  largest entry plus 1e-9 of the largest entry of its kind.
- `freeze_prefix` under two ranks: frozen leaves and their (non-zero)
  momentum unchanged, BN under the prefix unchanged.
- After every step the two ranks hold the same bytes.
- `all_gather_objects` ordered by rank, `any_rank`, the rank-strided
  training and evaluation loaders.
- Two-rank COCO and VOC evaluation equal to the one-process evaluation
  exactly and to the JAX package's (the same fake model in all three).
- `dryrun_data_parallel(2)` on the narrow model, one step.
- A SIGTERM to one of two `yolox-tpu-torch train` ranks: both leave at the
  same iteration with one resume checkpoint (the port's counterpart of
  `tests/test_preemption.py`).
"""

import os
import pickle
import re
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import yolox_tpu
import yolox_tpu_torch
from tests import _torch_dp as dp
from tests.test_voc import voc_dir  # noqa: F401  (the VOCdevkit fixture)
from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu.core import init_train_state as j_init
from yolox_tpu.core import make_train_step as j_make
from yolox_tpu.parallel.mesh import data_parallel_mesh, replicate, shard_batch
from yolox_tpu_torch.models.weights import nested_to_flat
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREEZE = "backbone.backbone"
STEP_CASES = ("fused_off", "fused_on")


def _batch():
    """The global batch of 4: rank 0 takes images 0-1 (3 and 2 boxes),
    rank 1 images 2-3 (1 box and none)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (4, dp.SIZE, dp.SIZE, 3))
    labels = np.zeros((4, 6, 5), np.float32)
    for b, n in enumerate((3, 2, 1, 0)):
        for i in range(n):
            w, h = rng.uniform(dp.SIZE / 8, dp.SIZE / 2, 2)
            labels[b, i] = [rng.integers(0, dp.NUM_CLASSES),
                            rng.uniform(w / 2, dp.SIZE - w / 2),
                            rng.uniform(h / 2, dp.SIZE - h / 2), w, h]
    return x, labels


def _with_val2017(coco_dir):
    """The synthetic set's images also as val2017, where `get_eval_dataset`
    looks for them."""
    val = os.path.join(coco_dir, "val2017")
    if not os.path.exists(val):
        os.symlink(os.path.join(coco_dir, "train2017"), val)
    return coco_dir


def _jax_start():
    jmod = JModule.from_config(dp.tiny_config(JConfig), rng_seed=0)
    with jax.enable_x64(True):
        params = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jmod.params)
        return jmod, jax.tree.map(np.asarray, j_init(params))


def _jax_dp_step(jmod, start, x, labels, fused_bwd):
    with jax.enable_x64(True):
        mesh = data_parallel_mesh(2)
        step = j_make(jmod, dp.NUM_CLASSES, compute_dtype=jnp.float64,
                      mesh=mesh, use_l1=True, fused_bwd=fused_bwd)
        state = replicate(mesh, jax.tree.map(jnp.asarray, start))
        xs, ls = shard_batch(mesh, jnp.asarray(x, jnp.float64),
                             jnp.asarray(labels))
        state, losses = step(state, xs, ls, jnp.asarray(0.01, jnp.float64))
        return (jax.tree.map(np.asarray, state),
                {k: float(v) for k, v in losses.items()})


@pytest.fixture(scope="module")
def run(coco_dir, voc_dir, tmp_path_factory):  # noqa: F811
    """Both ranks' records (`tests/_torch_dp.py::parallel_rank`), the JAX
    start state and JAX's two-device steps."""
    from yolox_tpu_torch.parallel.mesh import spawn_ranks

    root = str(tmp_path_factory.mktemp("dp"))
    x, labels = _batch()
    jmod, start = _jax_start()
    frozen_start = dict(start)
    rng = np.random.default_rng(5)
    frozen_start["momentum"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype),
        start["momentum"])
    cases = [("fused_off", start, dict(use_l1=True, fused_bwd=False)),
             ("fused_on", start, dict(use_l1=True, fused_bwd=True)),
             ("frozen", frozen_start, dict(use_l1=True, fused_bwd=True,
                                           freeze_prefix=FREEZE))]
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump({"x": x, "labels": labels, "cases": cases,
                     "coco_dir": _with_val2017(coco_dir),
                     "voc_root": voc_dir[0]}, f)
    spawn_ranks(dp.parallel_rank, (root,), dp.WORLD, dp.SPAWN_TIMEOUT_S)
    ranks = []
    for r in range(dp.WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    jax_steps = {name: _jax_dp_step(jmod, start, x, labels,
                                    kw["fused_bwd"])
                 for name, _, kw in cases if name in STEP_CASES}
    return {"ranks": ranks, "start": start, "frozen_start": frozen_start,
            "jax": jax_steps}


def _close(got, want, what):
    """`tests/test_torch_train.py`'s float64 allowance, tensor by tensor."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        own = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-6 * own + 1e-9 * scale, (what, k, err, own)


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_rank_step_matches_jax_mesh_step(run, case):
    want, want_l = run["jax"][case]
    got = run["ranks"][0][case]
    p0 = nested_to_flat(run["start"]["params"])
    for part in ("params", "momentum", "ema", "stats"):
        w, g = nested_to_flat(want[part]), nested_to_flat(got["state"][part])
        assert set(g) == set(w), part
        if part == "params":  # the updates, not the parameters
            w = {k: w[k] - p0[k] for k in w}
            g = {k: g[k] - p0[k] for k in g}
        for k in w:
            assert g[k].dtype == w[k].dtype, (part, k)
        _close(g, w, part)
    assert set(got["losses"]) == set(want_l)
    for k in want_l:
        assert got["losses"][k] == pytest.approx(want_l[k], rel=1e-6), k
    # the halves differ: a rank that skipped the mean would not match
    assert want_l["num_fg"] > 0


@pytest.mark.parametrize("case", STEP_CASES + ("frozen",))
def test_ranks_hold_the_same_state_after_the_step(run, case):
    a, b = (r[case] for r in run["ranks"])
    assert a["identical"] and b["identical"]
    for part in ("params", "momentum", "ema", "stats"):
        fa, fb = nested_to_flat(a["state"][part]), \
            nested_to_flat(b["state"][part])
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert a["losses"] == b["losses"]


def test_freeze_prefix_under_two_ranks(run):
    got = run["ranks"][1]["frozen"]["state"]
    start = run["frozen_start"]
    frozen = [k for k in nested_to_flat(start["params"])
              if k.startswith(FREEZE)]
    assert frozen
    for part in ("params", "momentum"):
        g, s = nested_to_flat(got[part]), nested_to_flat(start[part])
        for k in frozen:
            np.testing.assert_array_equal(g[k], s[k], err_msg=(part, k))
        moved = [k for k in s if not k.startswith(FREEZE)
                 and not np.array_equal(g[k], s[k])]
        assert moved, part
    g, s = nested_to_flat(got["stats"]), nested_to_flat(start["stats"])
    for k in s:
        if k.startswith(FREEZE):
            np.testing.assert_array_equal(g[k], s[k], err_msg=k)


def test_all_gather_objects_is_ordered_by_rank(run):
    for r, rec in enumerate(run["ranks"]):
        assert [o["rank"] for o in rec["gathered"]] == [0, 1]
        assert rec["gathered"][r]["pid"] != rec["gathered"][1 - r]["pid"]
        assert rec["any_rank"] == (True, False)


def test_loader_workers_fork_inside_a_spawned_rank(run):
    """A rank started by spawn would spawn its loader workers too (each
    re-importing torch at every loader start); the port's loaders fork."""
    for r in run["ranks"]:
        assert r["start_methods"] == ("spawn", "fork", "fork")


def test_distributed_loaders_split_the_batch_by_rank(run, coco_dir):
    a, b = (r["loader"] for r in run["ranks"])
    assert (a["batch_size"], a["rank"], a["world"]) == (dp.PER_RANK, 0, 2)
    assert (b["batch_size"], b["rank"], b["world"]) == (dp.PER_RANK, 1, 2)
    # the seeded permutation dealt out in turn: rank 0 the even places
    perm = [i for _ in range(2) for i in
            np.random.default_rng(0).permutation(12).tolist()][:12]
    got_a, got_b = sum(a["batches"], []), sum(b["batches"], [])
    assert [i for _, i, _ in got_a] == perm[0::2][:6]
    assert [i for _, i, _ in got_b] == perm[1::2][:6]
    # Mosaic/MixUp on: each rank augments its images from its own seeds,
    # and together they draw what one process draws for the same images
    assert all(m for m, _, _ in got_a + got_b)
    seeds_a, seeds_b = ({s for _, _, s in g} for g in (got_a, got_b))
    assert not seeds_a & seeds_b
    one = dp.tiny_config(yolox_tpu_torch.YoloxConfig, coco_dir) \
        .get_data_loader(dp.WORLD * dp.PER_RANK).batch_sampler
    batches = iter(one)
    want = sum((next(batches) for _ in range(3)), [])
    assert sorted(got_a + got_b) == sorted(want)
    assert got_a == want[0::2] and got_b == want[1::2]
    ids0, ids1 = (r["eval_ids"] for r in run["ranks"])
    assert ids0 == [0, 1, 4, 5, 8, 9] and ids1 == [2, 3, 6, 7, 10, 11]
    for r in run["ranks"]:  # a batch that does not divide over the ranks
        assert "must divide over the 2 ranks" in r["odd_batch"]


def _summary_without_timing(summary):
    return summary.split("\n", 1)[1]


def test_two_rank_coco_evaluation_equals_one_process_and_jax(run, coco_dir):
    from yolox_tpu.data import DataLoader as JDataLoader
    from yolox_tpu.data import SequentialBatchSampler as JSampler
    from yolox_tpu.evaluators import CocoEvaluator as JCocoEvaluator
    from yolox_tpu_torch.data import eval_loader
    from yolox_tpu_torch.evaluators import CocoEvaluator

    one = dp.evaluate(CocoEvaluator, eval_loader(
        dp.coco_dataset(coco_dir, yolox_tpu_torch), dp.PER_RANK),
        dp.NUM_CLASSES)
    jds = dp.coco_dataset(coco_dir, yolox_tpu)
    jax_res = dp.evaluate(JCocoEvaluator, JDataLoader(
        jds, batch_sampler=JSampler(len(jds), dp.PER_RANK)), dp.NUM_CLASSES)
    two = run["ranks"][0]["coco"]
    assert run["ranks"][1]["coco"] == (0, 0, None)
    assert 0.1 < one[0] < 0.95
    assert two[:2] == one[:2] == jax_res[:2]
    assert _summary_without_timing(two[2]) == \
        _summary_without_timing(one[2]) == _summary_without_timing(jax_res[2])


def test_two_rank_voc_evaluation_equals_one_process_and_jax(run, voc_dir):  # noqa: F811
    from yolox_tpu.data import DataLoader as JDataLoader
    from yolox_tpu.data import SequentialBatchSampler as JSampler
    from yolox_tpu.evaluators import VocEvaluator as JVocEvaluator
    from yolox_tpu_torch.data import eval_loader
    from yolox_tpu_torch.evaluators import VocEvaluator

    one = dp.evaluate(VocEvaluator, eval_loader(
        dp.voc_dataset(voc_dir[0], yolox_tpu_torch), dp.PER_RANK), 20)
    jds = dp.voc_dataset(voc_dir[0], yolox_tpu)
    jax_res = dp.evaluate(JVocEvaluator, JDataLoader(
        jds, batch_sampler=JSampler(len(jds), dp.PER_RANK)), 20)
    two = run["ranks"][0]["voc"]
    assert run["ranks"][1]["voc"] == (0, 0, None)
    assert one[1] > 0.05
    assert two == one == jax_res


@pytest.mark.parametrize("timeout", [None, 120])
def test_spawn_ranks_waits_for_ranks_that_end_apart(timeout):
    from yolox_tpu_torch.parallel.mesh import spawn_ranks

    t0 = time.monotonic()
    spawn_ranks(dp.sleeping_rank, ((0, 2),), 2, timeout)
    assert time.monotonic() - t0 >= 2


def test_spawn_ranks_kills_ranks_past_the_deadline():
    from yolox_tpu_torch.parallel.mesh import spawn_ranks

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2 running "
                       "sleeping_rank"):
        spawn_ranks(dp.sleeping_rank, ((0, 600),), 2, timeout=5)
    assert time.monotonic() - t0 < 60


def test_dryrun_data_parallel():
    from yolox_tpu_torch.parallel import dryrun_data_parallel

    out = dryrun_data_parallel(2, size=dp.SIZE,
                               cfg=dp.tiny_config(yolox_tpu_torch.YoloxConfig),
                               timeout=dp.COLLECTIVE_TIMEOUT_S)
    assert [r["gathered"] for r in out] == [[0, 1], [0, 1]]
    assert out[0]["total_loss"] == out[1]["total_loss"]
    assert np.isfinite(out[0]["total_loss"])


_PREEMPT_CFG = """
from tests._torch_dp import tiny_config
from yolox_tpu_torch import YoloxConfig


class PreemptConfig(YoloxConfig):
    def __init__(self):
        super().__init__("dp_preempt")
        cfg = tiny_config(YoloxConfig, {data!r}, {out!r})
        self.__dict__.update(cfg.__dict__)
        self.name = "dp_preempt"
        self.max_epoch = 1000           # far more than the test waits for
        self.warmup_epochs = 1
        self.no_aug_epochs = 0
        self.eval_interval = 10**6      # never evaluate
        self.print_interval = 1
        self.multiscale_range = 0
        self.save_history_ckpt = False
"""


def test_sigterm_to_one_rank_stops_both_at_one_iteration(coco_dir, tmp_path):
    """SIGTERM to rank 1 of a two-machine `yolox-tpu-torch train` (gloo on
    the CPU): at the next iteration boundary both ranks take the notice
    (a MAX all-reduce), rank 0 writes the resume checkpoint that redoes the
    epoch, and both exit 0 (a rank left waiting in a collective would
    fail or hang)."""
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    out = tmp_path / "out"
    (tmp_path / "dp_preempt_cfg.py").write_text(textwrap.dedent(
        _PREEMPT_CFG).format(data=_with_val2017(coco_dir), out=str(out)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), REPO, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS=str(max(1, tests._torch_threads.cpu_share() // 2)),
        PYTHONUNBUFFERED="1")
    # a rendezvous file, not a port freed for the ranks: another test
    # could take the port first
    url = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "yolox_tpu_torch.cli", "train", "-c",
         "dp_preempt_cfg:PreemptConfig", "-b", "4", "--device", "cpu",
         "--num_machines", "2", "--machine_rank", str(r), "--dist-url", url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    log = out / "dp_preempt" / "train_log.txt"
    try:
        deadline = time.time() + 240
        while not (log.exists() and "iter: 2/3" in log.read_text()):
            assert time.time() < deadline, "no training iteration in time"
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[0][-3000:] for p in procs]
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[-3000:] for o in outs]
    text = log.read_text()
    notices = re.findall(r"preemption notice at epoch (\d+) iter (\d+)", text)
    assert len(notices) == 1, text[-3000:]
    epoch = int(notices[0][0])
    ckpt = load_checkpoint(str(out / "dp_preempt" / "latest_ckpt.pth"))
    assert ckpt["start_epoch"] == epoch - 1  # the interrupted epoch redone
    assert "exiting cleanly" in text
