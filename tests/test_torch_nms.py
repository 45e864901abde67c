"""K2, the NMS kernel's plain version, and the port's postprocessing against
the JAX package's.

Keep masks are compared bit for bit with `nms_fixed` / `batched_nms_fixed`
(the XLA fixpoint `_greedy_suppress`) and with the Pallas kernel
`nms_pallas` in interpret mode, on random boxes and on the edge cases
where the two IoU forms could part ways. The postprocess paths are held to
JAX row for row on inputs full of tied scores and tied class maxima, where
only the tie-break order decides: exactly for the undecoded columns, at
rtol 1e-6 for columns that pass through exp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nms_edge_cases, random_boxes
from yolox_tpu.ops import nms as jnms
from yolox_tpu.ops.pallas_nms import nms_pallas
from yolox_tpu_torch.ops import nms as tnms
from yolox_tpu_torch.ops.boxes import (
    cxcywh2xyxy,
    pairwise_iou_xyxy,
    xyxy2cxcywh,
)
from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain


def _cases():
    rng = np.random.default_rng(0)
    boxes = random_boxes(rng, 3, 256)
    valid = rng.random((3, 256)) > 0.15
    eb, ev = nms_edge_cases()
    return [("random", boxes, valid), ("edge", eb, ev)]


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.65])
@pytest.mark.parametrize("case", ["random", "edge"])
def test_plain_keep_bit_equal_to_jax_and_pallas(case, thr):
    _, boxes, valid = dict((c[0], c) for c in _cases())[case]
    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    assert got.dtype == torch.bool
    for i in range(len(boxes)):
        jb, jv = jnp.asarray(boxes[i]), jnp.asarray(valid[i])
        want = np.asarray(jnms.nms_fixed(jb, None, thr, jv))
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=str(i))
        pallas = np.asarray(nms_pallas(jb, None, thr, jv, interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), pallas, err_msg=str(i))


def test_edge_cases_keep_what_greedy_nms_keeps():
    """Spot checks of the edge cases' meaning at thr 0.5."""
    boxes, valid = nms_edge_cases()
    keep = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                          0.5).numpy()
    assert keep[0].sum() == 1 and keep[0, 0]          # identical boxes
    np.testing.assert_array_equal(keep[1], valid[1])  # zero area: no overlap
    assert keep[2].all()                              # touching: IoU 0
    assert keep[4].all()                              # IoU == thr survives
    assert not keep[5].any()                          # all invalid


@pytest.mark.parametrize("thr", [0.45, 0.65])
def test_class_offset_path_bit_equal_to_jax(thr):
    rng = np.random.default_rng(1)
    boxes = random_boxes(rng, 2, 384)
    valid = rng.random((2, 384)) > 0.1
    classes = rng.integers(0, 5, (2, 384))
    scores = np.ones((2, 384), np.float32)
    got = tnms.batched_nms_fixed(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(classes), thr,
                                 torch.from_numpy(valid))
    for i in range(2):
        want = jnms.batched_nms_fixed(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(classes[i]), thr, jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    # unbatched (K, 4) form, and the class-agnostic path
    one = tnms.nms_fixed(torch.from_numpy(boxes[0]), None, thr,
                         torch.from_numpy(valid[0]))
    want = jnms.nms_fixed(jnp.asarray(boxes[0]), None, thr,
                          jnp.asarray(valid[0]))
    np.testing.assert_array_equal(one.numpy(), np.asarray(want))


def test_iou_bit_equal_to_jax():
    boxes, _ = nms_edge_cases()
    b = np.concatenate([boxes[1], boxes[3], random_boxes(
        np.random.default_rng(2), 1, 128)[0]])
    from yolox_tpu.ops.boxes import pairwise_iou_xyxy as jiou

    got = pairwise_iou_xyxy(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    want = np.asarray(jiou(jnp.asarray(b), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)  # NaN positions included


def test_box_conversions():
    from yolox_tpu.ops import boxes as jboxes

    b = random_boxes(np.random.default_rng(3), 2, 16)
    np.testing.assert_array_equal(
        xyxy2cxcywh(torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.xyxy2cxcywh(jnp.asarray(b))))
    np.testing.assert_array_equal(
        cxcywh2xyxy(torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.cxcywh2xyxy(jnp.asarray(b))))


def _tied_prediction(seed, b=2, a=300, c=6):
    """Decoded rows with few distinct values: scores tie across anchors and
    class maxima tie across classes."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, a, 5 + c), np.float32)
    pred[..., 0:2] = rng.integers(0, 40, (b, a, 2)) * 8.0
    pred[..., 2:4] = rng.choice([16.0, 32.0, 48.0], (b, a, 2))
    pred[..., 4] = rng.choice([0.5, 0.75, 1.0], (b, a))
    pred[..., 5:] = rng.choice([0.25, 0.5, 1.0], (b, a, c))
    pred[:, :10, 5:] = 0.5           # every class tied at the max
    return pred


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("max_det", [64, 512])
def test_postprocess_device_tie_order_matches_jax(max_det, agnostic):
    pred = _tied_prediction(4)
    want_d, want_v = jnms.postprocess_device(
        jnp.asarray(pred), 6, 0.3, 0.45, agnostic, max_det)
    got_d, got_v = tnms.postprocess_device(
        torch.from_numpy(pred), 6, 0.3, 0.45, agnostic, max_det)
    assert got_d.shape == (2, max_det, 7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_argmax_ties_pick_the_first_class():
    pred = _tied_prediction(5)
    _, cls = torch.from_numpy(pred[..., 5:]).max(dim=-1)
    np.testing.assert_array_equal(
        cls.numpy(), np.asarray(jnp.argmax(jnp.asarray(pred[..., 5:]), -1)))
    assert (cls[:, :10] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_levels_tie_order_matches_jax(dtype):
    """`postprocess_fused_levels` on raw per-level outputs with ties, in the
    head's dtype (bf16 serving makes ties common)."""
    rng = np.random.default_rng(6)
    sizes, strides = ((8, 8), (4, 4), (2, 2)), (8, 16, 32)
    c = 6
    outs, grids, strs = [], [], []
    for (h, w), s in zip(sizes, strides):
        o = np.zeros((2, h * w, 5 + c), np.float32)
        o[..., 0:2] = rng.choice([0.25, 0.5], (2, h * w, 2))
        o[..., 2:4] = rng.choice([0.0, 0.5, 1.0], (2, h * w, 2))
        o[..., 4] = rng.choice([0.5, 1.0], (2, h * w))
        o[..., 5:] = rng.choice([0.25, 0.5, 1.0], (2, h * w, c))
        outs.append(o)
        xv, yv = np.meshgrid(np.arange(w), np.arange(h))
        grids.append(np.stack([xv, yv], 2).reshape(-1, 2).astype(np.float32))
        strs.append(np.full((h * w, 1), s, np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_d, want_v = jnms.postprocess_fused_levels(
        [jnp.asarray(o, jdt) for o in outs],
        [jnp.asarray(g, jdt) for g in grids],
        [jnp.asarray(s, jdt) for s in strs], c, 0.2, 0.45, False, 32)
    got_d, got_v = tnms.postprocess_fused_levels(
        [torch.from_numpy(o).to(tdt) for o in outs],
        [torch.from_numpy(g).to(tdt) for g in grids],
        [torch.from_numpy(s).to(tdt) for s in strs], c, 0.2, 0.45, False, 32)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_payload_promotes_to_f32_past_256_classes():
    """bf16 holds class ids only up to 256: the payload table goes to f32."""
    c = 300
    out = torch.zeros((1, 4, 5 + c), dtype=torch.bfloat16)
    out[..., 5 + 299] = 1.0
    grid = torch.zeros((4, 2), dtype=torch.bfloat16)
    stride = torch.full((4, 1), 8.0, dtype=torch.bfloat16)
    _, tbl = tnms._score_and_payload(out, grid, stride, c, 0.1)
    assert tbl.dtype == torch.float32
    assert (tbl[..., 6] == 299).all()
    _, tbl = tnms._score_and_payload(out[..., :5 + 200], grid, stride, 200,
                                     0.1)
    assert tbl.dtype == torch.bfloat16


def test_wrapper_runs_plain_only_on_cpu_and_checks_inputs():
    boxes, valid = nms_edge_cases()
    before = nms_keep.launches
    nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert nms_keep.launches == before
    meta = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nms_keep(meta, torch.ones((1, 8), dtype=torch.bool, device="meta"),
                 0.5)
