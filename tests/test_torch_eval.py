"""The port's evaluation path against the JAX package's, on the CPU.

COCOeval on known-answer cases and random scenes (stats, precision and
recall within 1e-12; the native C++ matching, the python matching and the
columnar input equal), `CocoEvaluator` end to end on the synthetic COCO
set with a model that emits the ground truth (the same summary as JAX's),
a width-0.125 model at 128 px with the same weights in both packages
(per-image detections at `chip_smoke.assert_dets_match`'s rtol 1e-4 /
atol 1e-2, AP statistics within 1e-6: float32 convolutions sum in another
order, and the score threshold sits in a gap of the scores so both keep
the same candidates), `postprocess_device` past 1024 candidates, VOC's
`voc_eval` and `VocEvaluator`, and the config factories.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    IdsLoader,
    anchor_scores,
    assert_dets_match,
    gap_threshold,
    spread_scores,
)
from tests.test_voc import voc_dir  # noqa: F401  (the VOCdevkit fixture)
from yolox_tpu.data.coco_json import COCO as JCOCO
from yolox_tpu.evaluators.cocoeval import COCOeval as JCOCOeval
from yolox_tpu_torch.data.coco_json import COCO
from yolox_tpu_torch.evaluators.cocoeval import COCOeval

# --------------------------------------------------------------- COCOeval


def _gt(coco_cls, images, anns, cats=(1,)):
    coco = coco_cls()
    coco.dataset = {
        "images": [{"id": i, "width": 640, "height": 640} for i in images],
        "annotations": [
            {"id": k + 1, "image_id": a["image_id"],
             "category_id": a.get("category_id", 1), "bbox": a["bbox"],
             "area": a["bbox"][2] * a["bbox"][3],
             "iscrowd": a.get("iscrowd", 0)}
            for k, a in enumerate(anns)],
        "categories": [{"id": c, "name": f"c{c}"} for c in cats],
    }
    coco.create_index()
    return coco


def _run(coco_cls, eval_cls, images, anns, dets, cats=(1,), use_native=True):
    gt = _gt(coco_cls, images, anns, cats)
    res = dets if isinstance(dets, dict) else [dict(d) for d in dets]
    ev = eval_cls(gt, gt.loadRes(res), "bbox")
    ev.evaluate(use_native=use_native)
    ev.accumulate()
    with contextlib.redirect_stdout(io.StringIO()):
        ev.summarize()
    return ev


def _det(img, bbox, score, cat=1):
    return {"image_id": img, "category_id": cat, "bbox": bbox,
            "score": score}


# the known-answer scenes of tests/test_cocoeval.py
KNOWN = {
    "perfect": ([0, 1], [{"image_id": 0, "bbox": [10, 10, 100, 100]},
                         {"image_id": 1, "bbox": [50, 50, 80, 40]}],
                [_det(0, [10, 10, 100, 100], 0.9),
                 _det(1, [50, 50, 80, 40], 0.8)]),
    "half_recall": ([0], [{"image_id": 0, "bbox": [10, 10, 100, 100]},
                          {"image_id": 0, "bbox": [300, 300, 100, 100]}],
                    [_det(0, [10, 10, 100, 100], 0.9)]),
    "iou_threshold": ([0], [{"image_id": 0, "bbox": [0, 0, 100, 100]}],
                      [_det(0, [0, 0, 100, 62], 0.9)]),
    "crowd": ([0], [{"image_id": 0, "bbox": [10, 10, 100, 100]},
                    {"image_id": 0, "bbox": [300, 300, 200, 200],
                     "iscrowd": 1}],
              [_det(0, [10, 10, 100, 100], 0.9),
               _det(0, [320, 320, 100, 100], 0.8)]),
    "crowd_absent": ([0], [{"image_id": 0, "bbox": [10, 10, 100, 100]}],
                     [_det(0, [10, 10, 100, 100], 0.9),
                      _det(0, [320, 320, 100, 100], 0.8)]),
    "area_ranges": ([0], [{"image_id": 0, "bbox": [10, 10, 16, 16]},
                          {"image_id": 0, "bbox": [300, 300, 200, 200]}],
                    [_det(0, [10, 10, 16, 16], 0.9)]),
    "maxdets": ([0], [{"image_id": 0, "bbox": [10, 10, 100, 100]}],
                [_det(0, [400, 400, 50, 50], 0.95),
                 _det(0, [500, 500, 50, 50], 0.93),
                 _det(0, [10, 10, 100, 100], 0.9)]),
}


def _assert_same_eval(ev, jev, atol=1e-12):
    np.testing.assert_allclose(ev.stats, jev.stats, rtol=0, atol=atol)
    for key in ("precision", "recall", "scores"):
        np.testing.assert_allclose(ev.eval[key], jev.eval[key], rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", sorted(KNOWN))
def test_cocoeval_known_answers_match_jax(case, use_native):
    images, anns, dets = KNOWN[case]
    ev = _run(COCO, COCOeval, images, anns, dets, use_native=use_native)
    jev = _run(JCOCO, JCOCOeval, images, anns, dets, use_native=use_native)
    _assert_same_eval(ev, jev)
    assert ev.matcher == ("native" if use_native else "python")


def _random_scene(seed, n_dets=15, tie=0.9):
    rng = np.random.default_rng(seed)
    images = list(range(6))
    anns, dets = [], []
    for img in images:
        for _ in range(int(rng.integers(0, 8))):
            w, h = rng.uniform(5, 300, 2)
            x, y = rng.uniform(0, 600 - w), rng.uniform(0, 600 - h)
            anns.append({"image_id": img,
                         "category_id": int(rng.choice([1, 2])),
                         "bbox": [x, y, w, h],
                         "iscrowd": int(rng.random() < 0.2)})
        for _ in range(int(rng.integers(0, n_dets))):
            w, h = rng.uniform(5, 300, 2)
            x, y = rng.uniform(0, 600 - w), rng.uniform(0, 600 - h)
            dets.append(_det(img, [float(x), float(y), float(w), float(h)],
                             float(rng.choice([tie, tie,
                                               rng.uniform(0.05, 1.0)])),
                             int(rng.choice([1, 2]))))
    return images, anns, dets


def test_native_matching_equals_python_and_jax():
    """Crowds, area spread and score ties: the port's native and python
    matching agree with each other and with JAX's native matching."""
    images, anns, dets = _random_scene(0)
    native = _run(COCO, COCOeval, images, anns, dets, (1, 2), True)
    python = _run(COCO, COCOeval, images, anns, dets, (1, 2), False)
    jax_native = _run(JCOCO, JCOCOeval, images, anns, dets, (1, 2), True)
    assert (native.matcher, python.matcher) == ("native", "python")
    _assert_same_eval(native, python)
    _assert_same_eval(native, jax_native)


def test_columnar_equals_dict_path():
    """A columnar result dict gives the PR tensors of the per-ann dicts,
    score ties and the maxDets 100 truncation included."""
    images, anns, dets = _random_scene(7, n_dets=140, tie=0.7)
    columnar = {
        "image_id": np.array([d["image_id"] for d in dets], np.int64),
        "category_id": np.array([d["category_id"] for d in dets], np.int64),
        "bbox": np.array([d["bbox"] for d in dets], np.float64),
        "score": np.array([d["score"] for d in dets], np.float64),
    }
    ev_dict = _run(COCO, COCOeval, images, anns, dets, (1, 2))
    ev_col = _run(COCO, COCOeval, images, anns, columnar, (1, 2))
    _assert_same_eval(ev_col, ev_dict, atol=0)
    jev = _run(JCOCO, JCOCOeval, images, anns, columnar, (1, 2))
    _assert_same_eval(ev_col, jev)


# ----------------------------------------------------- evaluators end to end

NUM_CLASSES = 3  # the synthetic set's categories 1, 3, 7


class _GtModel:
    """Emits each ground-truth box of the batch's images as one decoded
    anchor at 0.99 (JAX's `test_cocoeval.py` FakeModel); `device` makes the
    port's evaluator put the batch on the CPU."""

    device = torch.device("cpu")

    def __init__(self, dataset, anchors=64):
        self.dataset, self.anchors, self.ids = dataset, anchors, []

    def predictions(self, b):
        out = np.zeros((b, self.anchors, 5 + NUM_CLASSES), np.float32)
        out[..., 2:4] = 1.0
        for i in range(b):
            for k, (x1, y1, x2, y2, cls) in enumerate(
                    self.dataset.load_anno(self.ids[i])):
                out[i, k, :4] = [(x1 + x2) / 2, (y1 + y2) / 2,
                                 max(x2 - x1, 1e-3), max(y2 - y1, 1e-3)]
                out[i, k, 4] = 0.99
                out[i, k, 5 + int(cls)] = 0.99
        return out

    def __call__(self, imgs):
        out = self.predictions(imgs.shape[0])
        return torch.from_numpy(out) if isinstance(imgs, torch.Tensor) \
            else out


def _loaders(coco_dir, img_size, batch_size=4):
    from yolox_tpu.data import CocoDataset as JCocoDataset
    from yolox_tpu.data import DataLoader as JDataLoader
    from yolox_tpu.data import SequentialBatchSampler as JSampler
    from yolox_tpu.data import ValTransform as JValTransform
    from yolox_tpu_torch.data import CocoDataset, ValTransform, eval_loader

    kw = dict(data_dir=coco_dir, json_file="instances_train2017.json",
              name="train2017", img_size=img_size)
    ds = CocoDataset(preproc=ValTransform(), **kw)
    jds = JCocoDataset(preproc=JValTransform(), **kw)
    return (eval_loader(ds, batch_size),
            JDataLoader(jds, batch_sampler=JSampler(len(jds), batch_size)))


def _summary_without_timing(summary):
    return summary.split("\n", 1)[1]


def test_coco_evaluator_ground_truth_model_matches_jax(coco_dir):
    from yolox_tpu.evaluators import CocoEvaluator as JCocoEvaluator
    from yolox_tpu_torch.evaluators import CocoEvaluator

    img_size = (64, 64)
    loader, jloader = _loaders(coco_dir, img_size)
    imgs, targets, infos, ids = next(iter(loader))
    jimgs, jtargets, jinfos, jids = next(iter(jloader))
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(targets, jtargets)
    assert infos == jinfos and [int(i[0]) for i in ids] == \
        [int(i[0]) for i in jids]

    results = []
    for ev_cls, ld in ((CocoEvaluator, loader), (JCocoEvaluator, jloader)):
        model = _GtModel(ld.dataset)
        ev = ev_cls(dataloader=IdsLoader(ld, model), img_size=img_size,
                    confthre=0.5, nmsthre=0.65, num_classes=NUM_CLASSES,
                    max_det=64)
        results.append(ev.evaluate(model))
    (ap, ap50, summary), (jap, jap50, jsummary) = results
    assert ap50 > 0.99 and ap > 0.9, summary
    assert (ap, ap50) == (jap, jap50)
    assert _summary_without_timing(summary) == \
        _summary_without_timing(jsummary)


def test_coco_evaluator_same_model_matches_jax(coco_dir):
    """yolox-s at width 0.125 (3 classes, 128 px), the same weights in both
    packages (`state_dict_to_jax`), scores spread so that a threshold sits
    in a gap: the per-image detections and the AP statistics agree."""
    from yolox_tpu import YoloxConfig as JConfig
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu.evaluators import CocoEvaluator as JCocoEvaluator
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.evaluators import CocoEvaluator
    from yolox_tpu_torch.models.weights import state_dict_to_jax

    img_size = (128, 128)
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width, cfg.num_classes = 0.125, NUM_CLASSES
    module = YoloxModule.from_config(cfg, rng_seed=1, device="cpu")
    loader, jloader = _loaders(coco_dir, img_size)
    imgs = np.concatenate([b[0] for b in loader])
    spread_scores(module, imgs[:4], std=2.0)
    jcfg = JConfig.get_named_config("yolox_s")
    jcfg.width, jcfg.num_classes = 0.125, NUM_CLASSES
    jmod = JModule.from_config(jcfg)
    jmod.load_params(jax.tree.map(jnp.asarray,
                                  state_dict_to_jax(module.state_dict())))
    conf, gap = gap_threshold(anchor_scores(module, imgs), 0.05, 0.3)
    assert gap > 1e-3

    runs = []
    for ev_cls, ld, model in ((CocoEvaluator, loader, module),
                              (JCocoEvaluator, jloader, jmod)):
        ev = ev_cls(dataloader=ld, img_size=img_size, confthre=conf,
                    nmsthre=0.65, num_classes=NUM_CLASSES)
        runs.append(ev.evaluate(model, return_outputs=True))
    ((ap, ap50, summary), out), ((jap, jap50, jsummary), jout) = runs
    assert set(out) == set(jout) and len(out) > 0
    for img_id in jout:
        rows = [np.concatenate([np.asarray(o["bboxes"]).reshape(-1, 4),
                                np.asarray(o["scores"])[:, None],
                                np.ones((len(o["scores"]), 1)),
                                np.asarray(o["categories"])[:, None]], 1)
                for o in (out[img_id], jout[img_id])]
        assert rows[0].shape == rows[1].shape
        n = len(rows[1])
        assert_dets_match(rows[0][None], np.ones((1, n), bool),
                          rows[1][None], np.ones((1, n), bool))
    assert ap == pytest.approx(jap, abs=1e-6)
    assert ap50 == pytest.approx(jap50, abs=1e-6)
    # the 12 statistics, printed to 3 decimals (random weights: the
    # recalls are not 0)
    stats = _summary_without_timing(summary).split("per class")[0]
    assert stats == _summary_without_timing(jsummary).split("per class")[0]
    assert "= 0.000" in stats and any(
        f"= {v}" in stats for v in ("0.00", "0.01", "0.02", "0.03"))


def test_postprocess_device_past_1024_candidates_matches_jax():
    """max_det 2048 over 3000 anchors: K 2048, past the old kernel's
    limit; the tie-heavy rows of `test_torch_nms._tied_prediction`."""
    from tests.test_torch_nms import _tied_prediction
    from yolox_tpu.ops import nms as jnms
    from yolox_tpu_torch.ops.nms import postprocess_device

    pred = _tied_prediction(8, b=2, a=3000)
    want_d, want_v = jnms.postprocess_device(jnp.asarray(pred), 6, 0.3,
                                             0.45, False, 2048)
    got_d, got_v = postprocess_device(torch.from_numpy(pred), 6, 0.3, 0.45,
                                      False, 2048)
    assert got_d.shape == (2, 2048, 7) and int(got_v.sum()) > 0
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


# ------------------------------------------------------------------ VOC


def _voc_datasets(root):
    from yolox_tpu.data import ValTransform as JValTransform
    from yolox_tpu.data.datasets import VocDetection as JVoc
    from yolox_tpu_torch.data import ValTransform, VocDetection

    kw = dict(image_sets=[("2007", "trainval")], img_size=(64, 64))
    return (VocDetection(root, preproc=ValTransform(), **kw),
            JVoc(root, preproc=JValTransform(), **kw))


class _VocModel:
    """Each image's ground truth, jittered, plus seeded random boxes over
    all 20 classes, as decoded anchors."""

    device = torch.device("cpu")

    def __init__(self, dataset):
        self.dataset, self.ids = dataset, []

    def __call__(self, imgs):
        b = imgs.shape[0]
        out = np.zeros((b, 48, 25), np.float32)
        for i in range(b):
            rng = np.random.default_rng(self.ids[i])
            out[i, :, :2] = rng.uniform(8, 56, (48, 2))
            out[i, :, 2:4] = rng.uniform(4, 30, (48, 2))
            out[i, :, 4] = rng.uniform(0.2, 0.9, 48)
            out[i, np.arange(48), 5 + rng.integers(0, 20, 48)] = 0.9
            for k, (x1, y1, x2, y2, cls) in enumerate(
                    self.dataset.load_anno(self.ids[i])):
                out[i, k, :5] = [(x1 + x2) / 2 + rng.uniform(-2, 2),
                                 (y1 + y2) / 2, x2 - x1, y2 - y1, 0.95]
                out[i, k, 5:] = 0
                out[i, k, 5 + int(cls)] = 0.95
        return torch.from_numpy(out) if isinstance(imgs, torch.Tensor) \
            else out


def test_voc_eval_matches_jax(voc_dir):  # noqa: F811
    from yolox_tpu.evaluators.voc_eval import voc_eval as jvoc_eval
    from yolox_tpu_torch.data.datasets.voc_classes import VOC_CLASSES
    from yolox_tpu_torch.evaluators import voc_eval

    root, boxes = voc_dir
    base = os.path.join(root, "VOC2007")
    det_file = os.path.join(root, "dets_{:s}.txt")
    rng = np.random.default_rng(3)
    for cls in VOC_CLASSES[:3]:
        with open(det_file.format(cls), "w") as f:
            for name, (c, box) in boxes.items():
                for _ in range(3):
                    jit = rng.uniform(-6, 6, 4) if c == cls else \
                        rng.uniform(-40, 40, 4)
                    f.write(f"{name} {rng.uniform(0.1, 1):.3f} "
                            + " ".join(f"{v:.1f}" for v in
                                       np.asarray(box) + jit) + "\n")
    for cls in VOC_CLASSES[:3]:
        for iou, use07 in ((0.5, True), (0.7, False)):
            args = (det_file, os.path.join(base, "Annotations", "{:s}.xml"),
                    os.path.join(base, "ImageSets", "Main", "trainval.txt"),
                    cls, os.path.join(root, "cache_eval_test"))
            got = voc_eval(*args, ovthresh=iou, use_07_metric=use07)
            want = jvoc_eval(*args, ovthresh=iou, use_07_metric=use07)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_voc_evaluator_matches_jax(voc_dir):  # noqa: F811
    from yolox_tpu.data import DataLoader as JDataLoader
    from yolox_tpu.data import SequentialBatchSampler as JSampler
    from yolox_tpu.evaluators import VocEvaluator as JVocEvaluator
    from yolox_tpu_torch.data import eval_loader
    from yolox_tpu_torch.evaluators import VocEvaluator

    root, _ = voc_dir
    ds, jds = _voc_datasets(root)
    results = []
    for ev_cls, ld in ((VocEvaluator, eval_loader(ds, 2)),
                       (JVocEvaluator, JDataLoader(jds, JSampler(len(jds),
                                                                 2)))):
        model = _VocModel(ld.dataset)
        ev = ev_cls(dataloader=IdsLoader(ld, model), img_size=(64, 64),
                    confthre=0.1, nmsthre=0.65, num_classes=20, max_det=48)
        results.append(ev.evaluate(model))
    (m, m50, summary), (jm, jm50, jsummary) = results
    assert m50 > 0.05
    assert (m, m50, summary) == (jm, jm50, jsummary)


# -------------------------------------------------------- config factories


def test_config_factories_build_the_evaluation(coco_dir):
    """get_eval_dataset, get_eval_loader, get_evaluator and eval on the
    synthetic set (served as val2017), a width-0.125 model at 64 px."""
    from torch.utils.data import DataLoader

    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.data import CocoDataset, SequentialBatchSampler
    from yolox_tpu_torch.evaluators import CocoEvaluator

    val = os.path.join(coco_dir, "val2017")
    if not os.path.exists(val):
        os.symlink(os.path.join(coco_dir, "train2017"), val)
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width, cfg.num_classes = 0.125, NUM_CLASSES
    cfg.data_dir, cfg.val_ann = coco_dir, "instances_train2017.json"
    cfg.test_size, cfg.data_num_workers, cfg.test_conf = (64, 64), 0, 1e-5
    ds = cfg.get_eval_dataset()
    assert isinstance(ds, CocoDataset) and len(ds) == 12
    loader = cfg.get_eval_loader(5)
    assert isinstance(loader, DataLoader) and len(loader) == 3
    assert isinstance(loader.batch_sampler, SequentialBatchSampler)
    imgs, targets, infos, ids = next(iter(loader))
    assert imgs.shape == (5, 64, 64, 3) and imgs.dtype == np.float32
    assert len(infos) == len(ids) == 5
    evaluator = cfg.get_evaluator(4)
    assert isinstance(evaluator, CocoEvaluator)
    assert (evaluator.confthre, evaluator.nmsthre, evaluator.max_det) == \
        (1e-5, 0.65, 1024)
    module = YoloxModule.from_config(cfg, device="cpu")
    ap, ap50, summary = cfg.eval(module, evaluator)
    assert 0.0 <= ap <= ap50 <= 1.0 and "Average Precision" in summary
    assert evaluator.matcher == "native"
    with pytest.raises(NotImplementedError, match="M7"):
        import yolox_tpu_torch.evaluators.coco_evaluator as ce

        orig = ce.process_rank_and_count
        ce.process_rank_and_count = lambda: (0, 2)
        try:
            cfg.eval(module, evaluator, is_distributed=True)
        finally:
            ce.process_rank_and_count = orig
