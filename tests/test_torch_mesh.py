"""The port's serving meshes (`yolox_tpu_torch/parallel/mesh.py`,
`parallel/halo.py`, `YoloxModule.make_serving_fn(mesh=...)`) on the CPU.

(a) In one process: the halo arithmetic on ints (`row_slabs`,
`extension`, `halo_moves`: every piece a rank receives is the piece its
neighbour sends, and the pieces fill the extended slab), and each op kind
run through `SpaceExchange.spatial` slab by slab (the neighbours' rows handed over
by a transport that reads them from the whole tensor), cropped and joined,
equal to the op on the whole tensor: convs k 1 and 3, stride 1 and 2,
dense and depthwise; K1's plain version on the NHWC image; Q1's and Q2's
plain versions (bit-exact, codes channels_last); the SPP pools 5/9/13 on
floats and on int8 codes; over two slabs, uneven slabs and slabs with
empty ranks (one-row slabs at stride 32, where the pools' 6-row halo
reaches across several ranks).

(b) One spawn of 8 gloo ranks (`tests/_torch_mesh.py::mesh_rank`) runs
the JAX package's mesh cases (`tests/test_parity_postprocess.py`,
`tests/test_quant.py`) with nano at 128 px: `data_parallel_mesh(8)` at
b8; (1, 8) at b1 (4 slabs of 32 rows, 4 empty ranks), (2, 4) at b2,
(4, 2) at b4; the int8 ladder and HBM over (2, 2) on the first 4 ranks;
yolov3 (Darknet-21) over (1, 2) on uint8 frames. The models' scores are
spread (`chip_smoke.spread_scores`): a seeded random model scores every
anchor ~1e-4, and oneDNN's convs round differently at batch 1 and 4, so
near-tied candidates would swap. Every rank's (dets, valid) is held:
- against the one-process `serve` of each data rank's images and of the
  whole batch: `valid` equal, `dets` at rtol 1e-6 / atol 1e-5 (the JAX
  package's own tolerance); float32 convs on a slab may round otherwise
  than on the whole image (oneDNN picks its algorithm by shape: up to
  1.3e-6 on yolov3's detections), the int8 modes are bit-equal to the
  former (exact float64 sums of the codes);
- against the JAX package's single-device `serve` on the same parameters
  (`models/weights.py`): float at `tests/test_torch_serve.py`'s
  tolerance and near-tie band; int8 with JAX's table, rows paired free of
  position at `chip_smoke.match_rows_free_labels`'s tolerances (a code
  that XLA and the port round to either side of a boundary moves a
  score; threshold in a gap of JAX's int8 scores, as
  `tests/test_torch_quant.py` does).
The halo exchanges a call (one per op that reads neighbouring rows, on a
rank with rows) and the ranks' bytes are checked too.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (
    GOLDEN_TIE,
    INT8_LABEL_FLIPS,
    assert_dets_match,
    gap_threshold,
    match_rows_free_labels,
    spread_scores,
)
from test_torch_quant import _jax_serve, _scores
from tests import _torch_mesh as tmesh
from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu.models.head import YoloxHead as JYoloxHead
from yolox_tpu.models.yolo_fpn import YoloFpn as JYoloFpn
from yolox_tpu_torch.models.blocks import (
    BaseConv,
    Focus,
    SPPBottleneck,
    max_pool_same,
)
from yolox_tpu_torch.models.weights import qtab_from_jax, state_dict_to_jax
from yolox_tpu_torch.ops import int8_conv as q
from yolox_tpu_torch.ops import quant
from yolox_tpu_torch.ops.stem import stem_conv_bn_act_plain
from yolox_tpu_torch.parallel import halo
from yolox_tpu_torch.parallel import mesh as pm
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

# ----------------------------------------------------- (a) one process

H_PX = 192          # the image height of the unit tests, 6 stride rows
SPLITS = {"two": 2, "uneven": 4, "empty": 8}   # space ranks
POOLS = (5, 9, 13)


def test_row_slabs():
    assert halo.row_slabs(128, 8) == ((0, 32), (32, 64), (64, 96),
                                      (96, 128)) + ((128, 128),) * 4
    assert halo.row_slabs(416, 2) == ((0, 224), (224, 416))
    assert halo.row_slabs(96, 4) == ((0, 32), (32, 64), (64, 96), (96, 96))
    assert halo.row_slabs(100, 1) == ((0, 100),)
    with pytest.raises(ValueError, match="multiple of 32"):
        halo.row_slabs(100, 2)


def test_extension_keeps_the_parity():
    assert [halo.extension(k, s) for k, s in
            ((1, 1), (3, 1), (3, 2), (6, 2), (13, 1))] == [0, 1, 2, 2, 6]


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("level,ext", [(1, 2), (8, 1), (16, 2), (32, 1),
                                       (32, 6)])
def test_halo_moves_pair_up_and_fill_the_slab(split, level, ext):
    slabs = halo.row_slabs(H_PX, SPLITS[split])
    moves = [halo.halo_moves(slabs, i, level, ext) for i in
             range(len(slabs))]
    for i, mv in enumerate(moves):
        r0, r1 = slabs[i][0] // level, slabs[i][1] // level
        if r0 == r1:
            assert not mv.recv and not mv.send
            continue
        assert (mv.lo, mv.hi) == (max(0, r0 - ext),
                                  min(H_PX // level, r1 + ext))
        rows = [r for _, a, b in mv.recv for r in range(a, b)]
        assert rows == list(range(mv.lo, r0)) + list(range(r1, mv.hi))
        for j, a, b in mv.recv:
            assert (i, a, b) in moves[j].send
        for j, a, b in mv.send:
            assert (i, a, b) in moves[j].recv


class _Neighbours:
    """A transport for one rank in one process: the rows it receives are
    read from the whole tensor (`pieces`: the rows of each receive, in
    the order `halo_moves` lists them)."""

    def __init__(self, whole, axis, pieces):
        self.whole, self.axis, self.pieces = whole, axis, pieces

    def exchange(self, sends, recvs, device):
        assert len(recvs) == len(self.pieces)
        out = []
        for (_, n), (_, a, b) in zip(recvs, self.pieces):
            buf = halo.as_bytes(self.whole.narrow(self.axis, a, b - a))
            assert buf.numel() == n
            out.append(buf)
        return out


def _join(parts, axis):
    first = parts[0]
    if isinstance(first, quant.QTensor):
        return quant.QTensor(torch.cat([p.codes for p in parts], axis),
                             first.scale)
    if isinstance(first, list):
        return [_join(list(p), axis) for p in zip(*parts)]
    return torch.cat(parts, axis)


def _slab_by_slab(op, whole, n_space, ksize, stride, axis=2):
    """`op` through `SpaceExchange.spatial` on every non-empty rank's slab of
    `whole` (a tensor or QTensor, rows along `axis`), joined."""
    t = whole.codes if isinstance(whole, quant.QTensor) else whole
    slabs = halo.row_slabs(H_PX, n_space)
    level = H_PX // t.shape[axis]
    parts = []
    for i, (a, b) in enumerate(slabs):
        if a == b:
            continue
        mv = halo.halo_moves(slabs, i, level, halo.extension(ksize, stride))
        ex = halo.SpaceExchange(slabs, i, range(n_space),
                                _Neighbours(t, axis, mv.recv))
        mine = t.narrow(axis, a // level, (b - a) // level)
        if isinstance(whole, quant.QTensor):
            mine = whole._replace(codes=mine)
        parts.append(ex.spatial(mine, ksize, stride, op, axis))
    return _join(parts, 2)


def _codes(gen, shape):
    c = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    return c.contiguous(memory_format=torch.channels_last)


def _op_case(kind, gen):
    """(input, op, ksize, stride, row axis of the input) of op `kind`."""
    if kind.startswith("conv"):  # conv<k>s<stride>[dw]
        k, s = int(kind[4]), int(kind[6])
        groups = 8 if kind.endswith("dw") else 1
        x = torch.randn(2, 8, H_PX // 8, 10, generator=gen)
        w = torch.randn(8, 8 // groups, k, k, generator=gen)
        return (x, lambda t: F.conv2d(t, w, None, s, (k - 1) // 2, 1, groups),
                k, s, 2)
    if kind == "stem_k1":
        x = torch.randint(0, 256, (2, H_PX, 12, 3), generator=gen).float()
        wb, scale, bias = (torch.randn(16, 3, 6, 6, generator=gen),
                           torch.rand(16, generator=gen) + 0.5,
                           torch.randn(16, generator=gen))
        return (x, lambda t: stem_conv_bn_act_plain(t, wb, scale, bias),
                6, 2, 1)
    if kind.startswith("q"):  # q1s<stride>, q2s<stride>, q1_requant
        s = 2 if kind.endswith("s2") else 1
        x = _codes(gen, (2, 16, H_PX // 16, 10))
        scale = torch.rand(16, generator=gen) * 1e-3
        bias = torch.randn(16, generator=gen)
        if kind.startswith("q2"):
            w = q.pack_dw_weight(torch.randint(-127, 128, (16, 1, 3, 3),
                                               generator=gen, dtype=torch.int8))
            return (x, lambda t: q.int8_dwconv_plain(
                t, w, scale, bias, 3, s, "silu"), 3, s, 2)
        w = q.pack_weight(torch.randint(-127, 128, (16, 16, 3, 3),
                                        generator=gen, dtype=torch.int8))
        out_scale = torch.rand(16, generator=gen) * 0.05 + 0.01 \
            if kind == "q1_requant" else None
        return (x, lambda t: q.int8_conv_plain(
            t, w, scale, bias, 3, s, "silu", out_scale=out_scale),
            3, s, 2)
    if kind == "pools":
        x = torch.randn(2, 8, H_PX // 32, 5, generator=gen)
        return (x, lambda t: [max_pool_same(t, k) for k in POOLS], 13, 1, 2)
    x = quant.QTensor(_codes(gen, (2, 16, H_PX // 32, 5)),
                      torch.rand(16, generator=gen) + 0.1)
    return (x, lambda t: [quant.q_max_pool_same(t, k) for k in POOLS],
            13, 1, 2)


OP_KINDS = ["conv1s1", "conv3s1", "conv3s2", "conv3s1dw", "conv3s2dw",
            "stem_k1", "q1s1", "q1s2", "q1_requant", "q2s1", "q2s2",
            "pools", "q_pools"]


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("kind", OP_KINDS)
def test_slabs_with_halos_equal_the_whole(kind, split):
    """Bit-equal: every output row is computed from the same rows, in the
    same order, as on the whole tensor."""
    gen = torch.Generator().manual_seed(OP_KINDS.index(kind))
    x, op, ksize, stride, axis = _op_case(kind, gen)
    got = _slab_by_slab(op, x, SPLITS[split], ksize, stride, axis)
    want = op(x)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        if isinstance(w, quant.QTensor):
            assert torch.equal(g.scale, w.scale)
            g, w = g.codes, w.codes
        assert g.dtype == w.dtype and torch.equal(g, w)
        if w.dtype == torch.int8 and w.dim() == 4:
            assert g.is_contiguous(memory_format=torch.channels_last)


def test_shardings_on_ints():
    mesh = pm.ServingMesh(2, 4, rank=6)
    assert mesh.coords == (1, 2) and mesh.size == 8
    assert pm.batch_sharding(mesh, 4) == slice(2, 4)
    shard = pm.image_sharding(mesh, 4, 416)
    assert shard.images == slice(2, 4) and shard.index == 2
    assert shard.rows == (224, 320) and shard.slabs == halo.row_slabs(416, 4)
    with pytest.raises(ValueError, match="does not split"):
        pm.batch_sharding(mesh, 3)
    with pytest.raises(ValueError, match="outside"):
        pm.batch_sharding(pm.ServingMesh(1, 2, rank=2), 2)


def test_one_process_meshes():
    """Without a process group: a (1, 1) mesh serves as `serve` does, bit
    for bit; a larger mesh, an object that is no mesh, and calibration
    inside a meshed call raise."""
    module = tmesh.nano()
    x = np.random.default_rng(1).uniform(0, 255, (1, 64, 64, 3))
    mesh = pm.serving_mesh(1, 1)
    assert pm.data_parallel_mesh().size == 1 and mesh.coords == (0, 0)
    fn = module.make_serving_fn(mesh=mesh, conf_thre=1e-5, max_det=16)
    for g, w in zip(fn(x), module.serve(x, conf_thre=1e-5, max_det=16)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.serving_mesh(1, 2)
    with pytest.raises(ValueError, match="process group of 1"):
        module.make_serving_fn(mesh=pm.ServingMesh(2, 1))
    with pytest.raises(TypeError, match="ServingMesh"):
        module.make_serving_fn(mesh=object())
    module.backbone.register_forward_hook(
        lambda *_: module.calibrate_int8(x))  # inside the meshed call
    with pytest.raises(RuntimeError, match="runs in one process"):
        fn(x)
    assert not module._meshed


# ------------------------------------------------ (b) 8 gloo ranks

CASES = ("data8", "1x8", "2x4", "4x2", "ladder2x2", "hbm2x2", "v3_1x2")
F32_KW = dict(conf_thre=1e-5, max_det=64)


def _preds(module):
    """The prediction convs' parameters (what `spread_scores` sets)."""
    return {k: v.clone() for k, v in module.state_dict().items()
            if "_preds." in k}


def _jax_params(module):
    return jax.tree.map(jnp.asarray, state_dict_to_jax(module.state_dict()))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Each case's inputs, the ranks' records, the one-process and JAX
    references."""
    root = str(tmp_path_factory.mktemp("mesh"))
    x8 = np.random.default_rng(7).uniform(
        0, 255, (8, tmesh.SIZE, tmesh.SIZE, 3)).astype(np.float32)
    nano = tmesh.nano()
    spread_scores(nano, x8[:2])
    jnano = JModule.from_config(JConfig.get_named_config("yolox_nano"))
    jnano.params = _jax_params(nano)
    xq = np.random.default_rng(5).uniform(
        0, 255, (2, tmesh.SIZE, tmesh.SIZE, 3)).astype(np.float32)
    jtable = jnano.calibrate_int8(jnano.params, jnp.asarray(xq))
    jax_int8 = _jax_serve(jnano, jnano.params, jtable, jnp.float32)
    thrs = []
    for outs, _, _ in jax_int8(xq, [0.5, 0.5]).values():
        s = _scores(outs)
        thr, gap = gap_threshold(s, *np.quantile(s, [0.9, 0.99]))
        assert gap > 2e-2, gap
        thrs.append(thr)
    table = qtab_from_jax(jtable)
    v3 = tmesh.yolov3_21()
    xv = np.random.default_rng(4).integers(
        0, 256, (1, tmesh.SIZE, tmesh.SIZE, 3), dtype=np.uint8)
    spread_scores(v3, xv)
    jv3 = JModule(JYoloFpn(depth=21), JYoloxHead(
        80, 1.0, in_channels=(128, 256, 512), act="lrelu"))
    jv3.params = _jax_params(v3)
    cases = [
        ("data8", "nano", ("data", 8), x8, F32_KW),
        ("1x8", "nano", (1, 8), x8[:1], F32_KW),
        ("2x4", "nano", (2, 4), x8[:2], F32_KW),
        ("4x2", "nano", (4, 2), x8[:4], F32_KW),
        ("ladder2x2", "nano", (2, 2), xq,
         dict(conf_thre=thrs[0], max_det=64, int8_qtab=table)),
        ("hbm2x2", "nano", (2, 2), xq,
         dict(conf_thre=thrs[1], max_det=64, int8_hbm_qtab=table)),
        ("v3_1x2", "yolov3", (1, 2), xv, F32_KW)]
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump({"cases": cases, "params": {"nano": _preds(nano),
                                                "yolov3": _preds(v3)}}, f)
    pm.spawn_ranks(tmesh.mesh_rank, (root,), tmesh.WORLD,
                   tmesh.SPAWN_TIMEOUT_S)
    ranks = []
    for r in range(tmesh.WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    jax_f32 = {"nano": jnano.make_serving_fn(**F32_KW)(jnano.params,
                                                       jnp.asarray(x8)),
               "yolov3": jv3.make_serving_fn(**F32_KW)(jv3.params,
                                                       jnp.asarray(xv))}
    jax_q = jax_int8(xq, thrs)
    out = {}
    for name, model, shape, x, kw in cases:
        module = nano if model == "nano" else v3
        n_data = shape[1] if shape[0] == "data" else shape[0]
        per = len(x) // n_data
        parts = [module.serve(x[d * per:(d + 1) * per], **kw)
                 for d in range(n_data)]
        if name.startswith(("ladder", "hbm")):
            mode = name[:-3]
            _, dets, valid = jax_q[mode]
        else:
            dets, valid = (np.asarray(a)[:len(x)] for a in jax_f32[model])
        out[name] = {
            "ranks": [r[name] for r in ranks if name in r],
            "by_data_rank": [torch.cat(p).numpy() for p in zip(*parts)],
            "one_process": [t.numpy() for t in module.serve(x, **kw)],
            "jax": (dets, valid), "module": module}
    return out


def _halo_ops(module):
    """The ops of `module`'s eval forward that read neighbouring rows: a
    BaseConv of ksize > 1 (not the one a Focus stem folds into K1), the
    Focus stem, each SPP block's pools."""
    stems = {id(m.conv) for m in module.modules() if isinstance(m, Focus)}
    return sum(1 for m in module.modules()
               if (isinstance(m, BaseConv) and m.conv.kernel_size[0] > 1
                   and id(m) not in stems)
               or isinstance(m, (Focus, SPPBottleneck)))


@pytest.mark.parametrize("name", CASES)
def test_meshed_serve_matches_one_process_and_jax(run, name):
    case = run[name]
    want_d, want_v = case["one_process"]
    ranks = case["ranks"]
    assert len(ranks) == {"ladder2x2": 4, "hbm2x2": 4, "v3_1x2": 2}.get(
        name, tmesh.WORLD)
    int8 = name.endswith("2x2")
    for r in ranks:
        for want in (case["by_data_rank"], case["one_process"]):
            np.testing.assert_array_equal(r["valid"], want[1])
            np.testing.assert_allclose(r["dets"], want[0], rtol=1e-6,
                                       atol=1e-5)
        if int8:
            np.testing.assert_array_equal(r["dets"],
                                          case["by_data_rank"][0])
    got_d, got_v = ranks[0]["dets"], ranks[0]["valid"]
    jax_d, jax_v = case["jax"]
    assert got_v.sum() >= 4
    if int8:
        np.testing.assert_array_equal(got_v, jax_v)
        flips = sum(match_rows_free_labels(g[v], w[v])[0]
                    for g, v, w in zip(got_d, jax_v, jax_d))
        assert flips <= INT8_LABEL_FLIPS * jax_v.sum(), flips
    else:
        assert_dets_match(got_d, got_v, jax_d, jax_v, tie=GOLDEN_TIE)
    # one exchange per op that reads neighbouring rows, on a rank with rows
    n_ops = _halo_ops(case["module"])
    for r in ranks:
        st = r["stats"]["space"]
        d, s = r["coords"]
        has_rows = name != "1x8" or s < 4
        if name in ("data8",):
            assert st["exchanges"] == 0 and st["gathers"] == 0
        else:
            assert st["exchanges"] == (n_ops if has_rows else 0)
            assert st["gathers"] == 1
            assert (st["exchange_bytes"] > 0) == has_rows
        assert r["stats"]["data"]["gathers"] == 1
