"""`remat` in the port: the training forward's stages under activation
checkpointing (`models/blocks.py::RematStages`), on the CPU.

- float64, `fused_bwd` off and on: one step with `remat=True` equals the
  step without it bit for bit (the recompute is the same arithmetic in
  the same order), and JAX's `make_train_step(remat=True)` within the
  float64 allowance of `tests/test_torch_train.py` (1e-6 of each
  tensor's largest entry plus 1e-9 of the largest entry of its kind;
  losses at rtol 1e-6). The model: yolox-s at depth 0.33, width 0.125,
  3 classes, 64 px, B 2.
- BN's running statistics move once a step under `remat`:
  `num_batches_tracked` counts 1 after one step and 2 after two, and the
  statistics equal those of the step without `remat`.
- The forward keeps fewer activations for the backward (saved-tensor
  hooks count them), and eval-mode forwards are untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dp as dp
from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu.core import init_train_state as j_init
from yolox_tpu.core import make_train_step as j_make
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.core import init_train_state, make_train_step
from yolox_tpu_torch.models.weights import (
    nested_to_flat,
    train_state_from_jax,
    train_state_to_jax,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)


def _batch():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (2, dp.SIZE, dp.SIZE, 3))
    labels = np.zeros((2, 4, 5), np.float32)
    labels[0, :2] = [[1, 20, 24, 16, 20], [2, 44, 40, 24, 18]]
    labels[1, 0] = [0, 32, 30, 28, 30]
    return x, labels


@pytest.fixture(scope="module")
def start():
    jmod = JModule.from_config(dp.tiny_config(JConfig), rng_seed=2)
    with jax.enable_x64(True):
        params = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jmod.params)
        return jmod, jax.tree.map(np.asarray, j_init(params))


def _port_steps(start, fused_bwd, remat, n=1):
    module = YoloxModule.from_config(dp.tiny_config(YoloxConfig),
                                     device="cpu").double()
    state = init_train_state(module)
    train_state_from_jax(start, state)
    step = make_train_step(module, dp.NUM_CLASSES,
                           compute_dtype=torch.float64, use_l1=True,
                           fused_bwd=fused_bwd, remat=remat)
    x, labels = _batch()
    for _ in range(n):
        state, losses = step(state, x, labels, 0.01)
    return state, {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("fused_bwd", [False, True])
def test_remat_step_equals_plain_step_and_jax_remat(start, fused_bwd):
    jmod, jstart = start
    got, got_l = _port_steps(jstart, fused_bwd, remat=True)
    plain, plain_l = _port_steps(jstart, fused_bwd, remat=False)
    got, plain = train_state_to_jax(got), train_state_to_jax(plain)
    assert got_l == plain_l
    for part in ("params", "momentum", "ema", "stats"):
        g, p = nested_to_flat(got[part]), nested_to_flat(plain[part])
        for k in p:
            np.testing.assert_array_equal(g[k], p[k], err_msg=(part, k))

    with jax.enable_x64(True):
        step = j_make(jmod, dp.NUM_CLASSES, compute_dtype=jnp.float64,
                      use_l1=True, fused_bwd=fused_bwd, remat=True)
        x, labels = _batch()
        want, want_l = step(jax.tree.map(jnp.asarray, jstart),
                            jnp.asarray(x, jnp.float64), jnp.asarray(labels),
                            jnp.asarray(0.01, jnp.float64))
        want = jax.tree.map(np.asarray, want)
    for k, v in want_l.items():
        assert got_l[k] == pytest.approx(float(v), rel=1e-6), k
    p0 = nested_to_flat(jstart["params"])
    for part in ("params", "momentum", "ema", "stats"):
        w, g = nested_to_flat(want[part]), nested_to_flat(got[part])
        if part == "params":
            w = {k: w[k] - p0[k] for k in w}
            g = {k: g[k] - p0[k] for k in g}
        scale = max(float(np.abs(v).max()) for v in w.values())
        for k in w:
            own = float(np.abs(w[k]).max())
            err = float(np.abs(g[k] - w[k]).max())
            assert err <= 1e-6 * own + 1e-9 * scale, (part, k, err)


@pytest.mark.parametrize("steps", [1, 2])
def test_remat_moves_running_statistics_once_a_step(start, steps):
    got, _ = _port_steps(start[1], True, remat=True, n=steps)
    plain, _ = _port_steps(start[1], True, remat=False, n=steps)
    counts = {name: int(b) for name, b in got.module.named_buffers()
              if name.endswith("num_batches_tracked")}
    assert counts and set(counts.values()) == {steps}
    want = dict(plain.module.named_buffers())
    for name, b in got.module.named_buffers():
        assert torch.equal(b, want[name]), name


def _saved_bytes(module, x, remat):
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = module.forward_train(x, remat=remat)
    return total, out


def test_remat_keeps_fewer_activations_for_the_backward():
    module = YoloxModule.from_config(dp.tiny_config(YoloxConfig),
                                     device="cpu").train()
    x = torch.from_numpy(_batch()[0]).float()
    plain, a = _saved_bytes(module, x, remat=False)
    remat, b = _saved_bytes(module, x, remat=True)
    assert remat < 0.6 * plain, (remat, plain)
    torch.testing.assert_close(b["outputs"], a["outputs"], rtol=0, atol=0)
    # an eval forward after a remat forward is the plain eval forward
    module.eval()
    with torch.no_grad():
        out = module(x)
    module.backbone.remat = False
    module.backbone.backbone.remat = False
    with torch.no_grad():
        assert torch.equal(module(x), out)
