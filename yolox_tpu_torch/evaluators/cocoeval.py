"""COCO detection evaluation (bbox), the port's copy of the JAX package's
`yolox_tpu/evaluators/cocoeval.py`: protocol-compatible with pycocotools'
COCOeval and self-contained, with an array-native design:

  - all annotations are flattened into structure-of-arrays form, grouped by
    (category, image); detections are score-sorted and truncated once;
  - greedy matching runs either in the C++ routine (`yolox_tpu_torch/native`)
    or a numpy fallback that is sequential only over detections — the
    (threshold x gt) candidate selection for each detection is one masked
    argmax, not a nested scan; `COCOeval.matcher` says which ran;
  - PR-curve accumulation is vectorized: one cumulative-sum / running-max /
    searchsorted pass per (category, area, maxDet) cell over all IoU
    thresholds at once. There are no per-image records ("evalImgs") at all;
    match results live in dense (area, threshold, detection) arrays.

All of it is host numpy: evaluation's device work ends with the
detections (`evaluators/coco_evaluator.py`).

Protocol semantics (identical to the canonical COCO evaluation):
  - IoU with crowd handling (intersection over dt area for iscrowd gts);
  - per-(image, category, area-range) greedy matching in score order,
    preferring higher IoU, never re-matching non-crowd gts, ignored gts
    matched only when no valid gt qualifies;
  - precision envelope + 101-point recall interpolation;
  - stats: AP, AP50, AP75, AP-S/M/L, AR@1/10/100, AR-S/M/L.
"""

from __future__ import annotations

import copy
import datetime
import time

import numpy as np

from yolox_tpu_torch.utils.logger import logger

_EPS = np.spacing(1)


class Params:
    def __init__(self, iouType="bbox"):
        assert iouType == "bbox", "only bbox evaluation is supported"
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(
            0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1, endpoint=True)
        self.recThrs = np.linspace(
            0.0, 1.00, int(np.round((1.00 - 0.0) / 0.01)) + 1, endpoint=True)
        self.maxDets = [1, 10, 100]
        self.areaRng = [
            [0 ** 2, 1e5 ** 2], [0 ** 2, 32 ** 2],
            [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2],
        ]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


def bbox_iou_crowd(dt_boxes, gt_boxes, iscrowd):
    """IoU of dt (D,4 xywh) x gt (G,4 xywh); crowd gts use dt-area union."""
    d = np.asarray(dt_boxes, np.float64)
    g = np.asarray(gt_boxes, np.float64)
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None, :])
                 - np.maximum(dx1[:, None], gx1[None, :]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None, :])
                 - np.maximum(dy1[:, None], gy1[None, :]), 0, None)
    inter = iw * ih
    d_area = (d[:, 2] * d[:, 3])[:, None]
    g_area = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(np.asarray(iscrowd, bool)[None, :],
                     d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / union, 0.0)


def _last_argmax(values, mask):
    """Row-wise index of the LAST maximum among masked entries, and whether
    any entry was masked-in. values (T, G), mask (T, G) -> ((T,), (T,))."""
    neg = np.where(mask, values, -np.inf)
    n = values.shape[1]
    idx = n - 1 - np.argmax(neg[:, ::-1], axis=1)
    return idx, mask.any(axis=1)


def match_greedy(ious, gt_ignore, gt_iscrowd, thresholds):
    """Greedy COCO matching for one (image, category, area-range) cell.

    ious: (D, G) with detections score-sorted and gts in evaluation order
    (non-ignored first, stable). gt_ignore / gt_iscrowd: (G,) bool in the
    same order. Returns (dt_matched, dt_ignored) of shape (T, D) plus the
    per-threshold matched-gt bookkeeping is internal.

    Equivalent to the canonical scan (each detection takes the
    highest-IoU available gt above the threshold, later index on ties,
    and falls back to ignored gts only when no valid gt qualifies), but
    expressed as two masked argmaxes over all thresholds at once; the only
    sequential dimension is the detections, whose greedy order is
    semantically load-bearing.
    """
    T = len(thresholds)
    D, G = ious.shape
    dt_matched = np.zeros((T, D), bool)
    dt_ignore = np.zeros((T, D), bool)
    if G == 0 or D == 0:
        return dt_matched, dt_ignore

    thr = np.minimum(np.asarray(thresholds, np.float64), 1 - 1e-10)[:, None]
    real = ~gt_ignore[None, :]                       # (1, G)
    crowd = gt_iscrowd[None, :]
    taken = np.zeros((T, G), bool)

    for d in range(D):
        iou_d = ious[d][None, :]                     # (1, G)
        candidate = (iou_d >= thr) & (~taken | crowd)
        # a valid (non-ignored) gt always beats any ignored gt: the scan
        # stops at the ignored region once a valid match exists
        pick, ok = _last_argmax(
            np.broadcast_to(iou_d, (T, G)), candidate & real)
        pick_ig, ok_ig = _last_argmax(
            np.broadcast_to(iou_d, (T, G)), candidate & ~real)
        pick = np.where(ok, pick, pick_ig)
        hit = ok | ok_ig
        rows = np.nonzero(hit)[0]
        cols = pick[rows]
        taken[rows, cols] = True
        dt_matched[rows, d] = True
        dt_ignore[rows, d] = gt_ignore[cols]
    return dt_matched, dt_ignore


class COCOeval:
    """Drop-in for pycocotools.cocoeval.COCOeval (bbox).

    Public surface: evaluate() -> accumulate() -> summarize(); results in
    .stats (12,) and .eval["precision"/"recall"/"scores"].
    """

    def __init__(self, cocoGt=None, cocoDt=None, iouType="bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.eval = {}
        self.stats = []
        self.evalImgs = None  # sentinel only; match state is array-native
        self._match = None
        self.matcher = None  # "native" or "python" after evaluate()
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ---------------------------------------------------------- gathering

    def _dt_columnar(self):
        """Detections as flat arrays {image_id, category_id, bbox, score}.

        Fast path: a columnar cocoDt (`coco_json.COCO.loadRes` of a
        columnar dict — detections never materialize as per-ann python
        dicts, which at millions of detections take tens of GB of host
        memory). Fallback: flatten the classic per-ann dicts once.
        """
        col = getattr(self.cocoDt, "columnar", None)
        if col is not None:
            n = len(col["score"])
            return {
                "image_id": np.asarray(col["image_id"], np.int64),
                "category_id": np.asarray(col["category_id"], np.int64),
                "bbox": np.asarray(col["bbox"],
                                   np.float64).reshape(n, 4),
                "score": np.asarray(col["score"], np.float64),
            }
        p = self.params
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
        n = len(dts)
        return {
            "image_id": np.fromiter(
                (d["image_id"] for d in dts), np.int64, n),
            "category_id": np.fromiter(
                (d["category_id"] for d in dts), np.int64, n),
            "bbox": np.array([d["bbox"] for d in dts],
                             np.float64).reshape(n, 4),
            "score": np.fromiter(
                (d["score"] for d in dts), np.float64, n),
        }

    def _gather(self):
        """Flatten annotations into per-(category, image) groups.

        Group order is category-major (categories in params order, images
        in params order within), so each category's detections occupy one
        contiguous slice of the flat arrays. Detections are handled
        columnar end-to-end (`_dt_columnar`): one global stable sort
        (group key asc, score desc, submission order) + per-group
        truncation to maxDets replaces the per-group python sorting.
        """
        p = self.params
        cat_ids = p.catIds if p.useCats else [-1]
        max_det = p.maxDets[-1]

        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
        gt_by_key = {}
        for g in gts:
            key = (g["category_id"] if p.useCats else -1, g["image_id"])
            gt_by_key.setdefault(key, []).append(g)

        col = self._dt_columnar()
        n_img = len(p.imgIds)

        def index_in(sorted_ids, values):
            """values -> positions in sorted_ids, -1 where absent
            (vectorized — a python dict lookup per detection is seconds
            of pure-python time at the 5M-det scale)."""
            ids = np.asarray(sorted_ids, np.int64)
            idx = np.searchsorted(ids, values)
            ok = idx < ids.size
            idx = np.where(ok, idx, 0)
            return np.where(ok & (ids[idx] == values), idx, -1)

        ii = index_in(p.imgIds, col["image_id"])
        if p.useCats:
            ki_arr = index_in(cat_ids, col["category_id"])
        else:
            ki_arr = np.zeros(ii.size, np.int64)
        keep = (ki_arr >= 0) & (ii >= 0)
        key = ki_arr[keep] * n_img + ii[keep]
        score = col["score"][keep]
        bbox = col["bbox"][keep]
        # stable: group asc, score desc, ties in submission order (the
        # dict path's per-group mergesort semantics)
        order = np.lexsort((-score, key))
        key_s, score_s, bbox_s = key[order], score[order], bbox[order]
        uniq, start, counts = np.unique(
            key_s, return_index=True, return_counts=True)
        rank = np.arange(key_s.size) - np.repeat(start, counts)
        trunc = rank < max_det
        key_s, score_s, bbox_s = key_s[trunc], score_s[trunc], bbox_s[trunc]
        uniq, start, counts = np.unique(
            key_s, return_index=True, return_counts=True)
        dt_slices = {int(k): (int(s), int(s + c))
                     for k, s, c in zip(uniq, start, counts)}

        groups = []          # (cat_index, (dt_start, dt_end), gt list)
        for ki, cat in enumerate(cat_ids):
            base = ki * n_img
            for img_i, img in enumerate(p.imgIds):
                gt = gt_by_key.get((cat, img), [])
                sl = dt_slices.get(base + img_i)
                if not gt and sl is None:
                    continue
                groups.append((ki, sl or (0, 0), gt))

        self._n_groups = len(groups)
        self._group_cat = np.array([g[0] for g in groups], np.int64)
        self._dt_counts = np.array(
            [sl[1] - sl[0] for _, sl, _ in groups], np.int64)
        self._gt_counts = np.array([len(gt) for _, _, gt in groups],
                                   np.int64)

        # dt flat arrays: group-ascending == sorted array order already
        flat_gt = [g for _, _, gt in groups for g in gt]
        self._dt_score = score_s
        self._dt_area = bbox_s[:, 2] * bbox_s[:, 3]
        self._gt_area = np.array(
            [g["area"] for g in flat_gt], np.float64)
        self._gt_crowd = np.array(
            [bool(g.get("iscrowd", 0)) for g in flat_gt], bool)
        self._gt_ignore_base = np.array(
            [bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
             for g in flat_gt], bool)

        self._ious = [
            bbox_iou_crowd(
                bbox_s[sl[0]:sl[1]], [g["bbox"] for g in gt],
                [int(g.get("iscrowd", 0)) for g in gt])
            for _, sl, gt in groups
        ]

    # ----------------------------------------------------------- matching

    def evaluate(self, use_native: bool = True):
        tic = time.time()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self._gather()

        native = None
        if use_native:
            from yolox_tpu_torch.native import load_cocoeval_lib

            native = load_cocoeval_lib()
        if native is not None and self._n_groups > 0:
            self._match_native()
            self.matcher = "native"
        else:
            self._match_python()
            self.matcher = "python"
        self.evalImgs = True
        self._paramsEval = copy.deepcopy(self.params)
        logger.info(f"COCOeval evaluate done (t={time.time() - tic:.2f}s, "
                    f"matching: {self.matcher})")

    def _alloc_match(self):
        p = self.params
        A, T = len(p.areaRng), len(p.iouThrs)
        n_dt, n_gt = int(self._dt_counts.sum()), int(self._gt_counts.sum())
        self._match = {
            "dtm": np.zeros((A, T, n_dt), bool),
            "dtig": np.zeros((A, T, n_dt), bool),
            "gtig": np.zeros((A, n_gt), bool),
        }

    def _match_python(self):
        p = self.params
        thrs = np.asarray(p.iouThrs, np.float64)
        self._alloc_match()
        m = self._match
        dt_start = np.concatenate([[0], np.cumsum(self._dt_counts)])
        gt_start = np.concatenate([[0], np.cumsum(self._gt_counts)])
        area_rng = np.asarray(p.areaRng, np.float64)

        for g in range(self._n_groups):
            ds, de = dt_start[g], dt_start[g + 1]
            gs, ge = gt_start[g], gt_start[g + 1]
            ig_base = self._gt_ignore_base[gs:ge]
            crowd = self._gt_crowd[gs:ge]
            g_area = self._gt_area[gs:ge]
            d_area = self._dt_area[ds:de]
            ious = self._ious[g]
            for a, (lo, hi) in enumerate(area_rng):
                ignore = ig_base | (g_area < lo) | (g_area > hi)
                order = np.argsort(ignore, kind="mergesort")
                dtm, dtig = match_greedy(
                    ious[:, order] if ious.size else ious,
                    ignore[order], crowd[order], thrs)
                outside = (d_area < lo) | (d_area > hi)
                dtig |= ~dtm & outside[None, :]
                m["dtm"][a, :, ds:de] = dtm
                m["dtig"][a, :, ds:de] = dtig
                m["gtig"][a, gs:ge] = ignore[order]

    def _match_native(self):
        """Run matching in the C++ routine and scatter its per-(group, area)
        blocks into the dense (area, threshold, detection) arrays."""
        from yolox_tpu_torch.native import cocoeval_evaluate_native

        p = self.params
        T, A = len(p.iouThrs), len(p.areaRng)
        dt_off = np.concatenate([[0], np.cumsum(self._dt_counts)])
        gt_off = np.concatenate([[0], np.cumsum(self._gt_counts)])
        iou_off = np.concatenate(
            [[0], np.cumsum([i.size for i in self._ious])])[:-1]
        iou_flat = (np.concatenate([i.reshape(-1) for i in self._ious])
                    if self._ious else np.zeros(0, np.float64))

        dt_matched, dt_ignored, gt_ignored, out_dt_off, out_gt_off = \
            cocoeval_evaluate_native(
                dt_off, gt_off, iou_off.astype(np.int64),
                self._dt_area, self._gt_area,
                self._gt_crowd.astype(np.uint8),
                self._gt_ignore_base.astype(np.uint8),
                iou_flat, np.asarray(p.iouThrs, np.float64),
                np.asarray(p.areaRng, np.float64), p.maxDets[-1])

        self._alloc_match()
        m = self._match
        n_dt = int(self._dt_counts.sum())
        n_gt = int(self._gt_counts.sum())
        # block r = g * A + a holds a (T, D_g) row-major slab at
        # element offset out_dt_off[r] * T; gather every slab of area a
        # into the dense arrays with one fancy index
        g_of_dt = np.repeat(np.arange(self._n_groups), self._dt_counts)
        d_in_g = np.arange(n_dt) - dt_off[g_of_dt]
        dcnt = self._dt_counts[g_of_dt]
        g_of_gt = np.repeat(np.arange(self._n_groups), self._gt_counts)
        j_in_g = np.arange(n_gt) - gt_off[g_of_gt]
        t_col = np.arange(T)[:, None]
        for a in range(A):
            base = out_dt_off[g_of_dt * A + a] * T
            idx = base[None, :] + t_col * dcnt[None, :] + d_in_g[None, :]
            m["dtm"][a] = dt_matched[idx].astype(bool)
            m["dtig"][a] = dt_ignored[idx].astype(bool)
            gidx = out_gt_off[g_of_gt * A + a] + j_in_g
            m["gtig"][a] = gt_ignored[gidx].astype(bool)

    # --------------------------------------------------------- accumulate

    def accumulate(self, p=None):
        tic = time.time()
        if self._match is None:
            logger.warning("Please run evaluate() first")
            return
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))
        rec_thrs = np.asarray(p.recThrs, np.float64)
        max_dets = np.asarray(p.maxDets)

        m = self._match
        # per-detection metadata in flat order (category-major groups)
        g_of_dt = np.repeat(np.arange(self._n_groups), self._dt_counts)
        dt_start = np.concatenate([[0], np.cumsum(self._dt_counts)])
        dt_rank = np.arange(len(g_of_dt)) - dt_start[g_of_dt]
        dt_cat = self._group_cat[g_of_dt]
        g_of_gt = np.repeat(np.arange(self._n_groups), self._gt_counts)
        gt_cat = self._group_cat[g_of_gt]

        for k in range(K):
            if not (self._group_cat == k).any():
                continue  # no image has annotations for this category
            dsel = np.nonzero(dt_cat == k)[0]
            gsel = gt_cat == k
            # one score sort per category (stable: ties keep image order),
            # shared by every (area, maxDet) cell
            order = dsel[np.argsort(-self._dt_score[dsel], kind="mergesort")]
            score_sorted = self._dt_score[order]
            rank_sorted = dt_rank[order]
            keep_by_m = rank_sorted[None, :] < max_dets[:, None]  # (M, nd)

            for a in range(A):
                npig = int(np.count_nonzero(~m["gtig"][a][gsel]))
                if npig == 0:
                    continue
                dtm_a = m["dtm"][a][:, order]
                dtig_a = m["dtig"][a][:, order]
                for mi in range(M):
                    keep = keep_by_m[mi]
                    dtm = dtm_a[:, keep]
                    dtig = dtig_a[:, keep]
                    ss = score_sorted[keep]
                    nd = dtm.shape[1]

                    tp = np.cumsum(dtm & ~dtig, axis=1, dtype=np.float64)
                    fp = np.cumsum(~dtm & ~dtig, axis=1, dtype=np.float64)
                    rc = tp / npig
                    pr = tp / (tp + fp + _EPS)
                    recall[:, k, a, mi] = rc[:, -1] if nd else 0.0
                    # precision envelope: running max from the right,
                    # all thresholds at once
                    env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    q = np.zeros((T, R))
                    s = np.zeros((T, R))
                    for t in range(T):
                        pos = np.searchsorted(rc[t], rec_thrs, side="left")
                        ok = pos < nd
                        q[t, ok] = env[t, pos[ok]]
                        s[t, ok] = ss[pos[ok]]
                    precision[:, :, k, a, mi] = q
                    scores[:, :, k, a, mi] = s

        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        logger.info(f"COCOeval accumulate done (t={time.time() - tic:.2f}s)")

    # ---------------------------------------------------------- summarize

    def summarize(self):
        """Print the 12 standard COCO metric lines and fill ``self.stats``.

        Each stat is one row of a spec table: pick precision or recall,
        optionally slice to a single IoU threshold, select one (area,
        maxDets) cell, and average the valid (> -1) entries.  The last two
        tensor axes are always (area, maxDets), so a single selection path
        serves both the AP tensor (T, R, K, A, M) and the AR tensor
        (T, K, A, M).
        """
        if not self.eval:
            raise Exception("Please run accumulate() first")
        p = self.params
        md = p.maxDets
        # (metric, iouThr or None for the full range, area label, maxDets)
        spec_rows = [
            ("AP", None, "all", 100),
            ("AP", 0.50, "all", md[2]),
            ("AP", 0.75, "all", md[2]),
            ("AP", None, "small", md[2]),
            ("AP", None, "medium", md[2]),
            ("AP", None, "large", md[2]),
            ("AR", None, "all", md[0]),
            ("AR", None, "all", md[1]),
            ("AR", None, "all", md[2]),
            ("AR", None, "small", md[2]),
            ("AR", None, "medium", md[2]),
            ("AR", None, "large", md[2]),
        ]
        full_range = "{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
        self.stats = np.zeros(len(spec_rows))
        for i, (metric, iou, area, max_det) in enumerate(spec_rows):
            s = self.eval["precision" if metric == "AP" else "recall"]
            if iou is not None:
                s = s[p.iouThrs == iou]
            # select the (area, maxDets) cell; an unknown label/count gives
            # an empty selection and therefore a -1 stat, like pycocotools
            a = [j for j, lbl in enumerate(p.areaRngLbl) if lbl == area]
            m = [j for j, n in enumerate(md) if n == max_det]
            vals = s[..., a, m]
            vals = vals[vals > -1]
            self.stats[i] = vals.mean() if vals.size else -1.0
            title = ("Average Precision" if metric == "AP"
                     else "Average Recall")
            iou_str = full_range if iou is None else "{:0.2f}".format(iou)
            print(" {:<18} ({}) @[ IoU={:<9} | area={:>6s} | maxDets={:>3d}"
                  " ] = {:0.3f}".format(title, metric, iou_str, area,
                                        max_det, self.stats[i]))
