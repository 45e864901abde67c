// Fast COCO evaluation matching kernel (C ABI, ctypes-loaded).
//
// The PyTorch port's copy of yolox_tpu/native/cocoeval.cpp, a native
// re-design of upstream YOLOX's pybind11 COCOeval accelerator — same greedy
// matching semantics as pycocotools' evaluateImg, run for every
// (image, category, area-range) in one call:
//
//   for each IoU threshold t, for each detection (score-descending):
//     pick the best gt by IoU among gts not yet matched (crowd gts can be
//     matched repeatedly); once a non-ignored gt has been matched, stop
//     scanning when the ignored-gt region begins; record match + ignore.
//   unmatched detections outside the area range are marked ignored.
//
// The Python side (yolox_tpu_torch/evaluators/cocoeval.py) keeps IoU computation
// (vectorized numpy) and PR-curve accumulation; this kernel removes the
// T x D x G Python loop, the hot part for large evaluations.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC cocoeval.cpp -o libcocoeval.so
// (yolox_tpu_torch/native/__init__.py builds it into yolox_tpu_torch/_build/)

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" {

// Evaluate matching for one batch of (image, category) groups across
// `n_area` area ranges.
//
// Group g has detections dt_off[g]..dt_off[g+1] (score-sorted descending)
// and ground truths gt_off[g]..gt_off[g+1]; its IoU matrix (row-major
// D x G, dt-major) starts at iou_off[g].
//
// Outputs are laid out per (group, area): for group g and area a, the
// result block index is r = g * n_area + a, with detection-level arrays at
// out_dt_off[r] * n_thr (set by caller as cumulative D per block):
//   dt_matched: uint8 [n_thr * D]   (1 if matched at threshold t)
//   dt_ignored: uint8 [n_thr * D]
//   gt_ignored: uint8 [G]           per (group, area) at out_gt_off[r]
void cocoeval_evaluate(
    // group structure
    int64_t n_groups,
    const int64_t* dt_off,      // n_groups + 1
    const int64_t* gt_off,      // n_groups + 1
    const int64_t* iou_off,     // n_groups (start of each D*G block)
    // detections (score-sorted within group)
    const double* dt_areas,
    // ground truths
    const double* gt_areas,
    const uint8_t* gt_iscrowd,
    const uint8_t* gt_ignore_base,   // ignore | iscrowd
    const double* ious,              // concatenated D x G blocks
    // evaluation params
    int64_t n_thr,
    const double* iou_thrs,
    int64_t n_area,
    const double* area_rngs,         // n_area * 2
    int64_t max_det,
    // outputs
    const int64_t* out_dt_off,       // n_groups * n_area + 1 (D' per block)
    const int64_t* out_gt_off,       // n_groups * n_area + 1 (G per block)
    uint8_t* dt_matched,             // sum(D') * n_thr
    uint8_t* dt_ignored,             // sum(D') * n_thr
    uint8_t* gt_ignored              // sum(G) over blocks
) {
  std::vector<int> gt_order;
  std::vector<uint8_t> gt_ig;
  std::vector<int64_t> gtm;

  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t d0 = dt_off[g];
    const int64_t g0 = gt_off[g];
    const int64_t D_all = dt_off[g + 1] - d0;
    const int64_t G = gt_off[g + 1] - g0;
    const int64_t D = D_all < max_det ? D_all : max_det;
    const double* iou_blk = ious + iou_off[g];
    const int64_t iou_cols = G;

    for (int64_t a = 0; a < n_area; ++a) {
      const int64_t r = g * n_area + a;
      const double lo = area_rngs[a * 2 + 0];
      const double hi = area_rngs[a * 2 + 1];

      // per-area gt ignore + stable sort (non-ignored first)
      gt_ig.assign(G, 0);
      for (int64_t j = 0; j < G; ++j) {
        const double area = gt_areas[g0 + j];
        gt_ig[j] = (gt_ignore_base[g0 + j] || area < lo || area > hi) ? 1 : 0;
      }
      gt_order.clear();
      gt_order.reserve(G);
      for (int64_t j = 0; j < G; ++j)
        if (!gt_ig[j]) gt_order.push_back((int)j);
      const int64_t n_valid = (int64_t)gt_order.size();
      for (int64_t j = 0; j < G; ++j)
        if (gt_ig[j]) gt_order.push_back((int)j);

      uint8_t* gt_ig_out = gt_ignored + out_gt_off[r];
      for (int64_t j = 0; j < G; ++j) gt_ig_out[j] = gt_ig[gt_order[j]];

      uint8_t* dtm_out = dt_matched + out_dt_off[r] * n_thr;
      uint8_t* dtig_out = dt_ignored + out_dt_off[r] * n_thr;

      gtm.assign((size_t)(n_thr * G), -1);
      for (int64_t t = 0; t < n_thr; ++t) {
        const double thr = iou_thrs[t] < (1.0 - 1e-10)
                               ? iou_thrs[t]
                               : (1.0 - 1e-10);
        for (int64_t d = 0; d < D; ++d) {
          double best = thr;
          int64_t m = -1;
          for (int64_t jj = 0; jj < G; ++jj) {
            const int64_t j = gt_order[jj];
            const bool crowd = gt_iscrowd[g0 + j] != 0;
            if (gtm[t * G + jj] >= 0 && !crowd) continue;
            // gts are sorted valid-first; once matched to a valid gt,
            // don't take an ignored one
            if (m > -1 && jj >= n_valid && m < n_valid) break;
            const double iou = iou_blk[d * iou_cols + j];
            if (iou < best) continue;
            best = iou;
            m = jj;
          }
          const int64_t idx = t * D + d;
          if (m == -1) {
            dtm_out[idx] = 0;
            dtig_out[idx] = 0;
          } else {
            gtm[t * G + m] = d;
            dtm_out[idx] = 1;
            dtig_out[idx] = gt_ig[gt_order[m]];
          }
        }
        // unmatched dts outside the area range are ignored
        for (int64_t d = 0; d < D; ++d) {
          const int64_t idx = t * D + d;
          if (!dtm_out[idx]) {
            const double area = dt_areas[d0 + d];
            if (area < lo || area > hi) dtig_out[idx] = 1;
          }
        }
      }
    }
  }
}

}  // extern "C"
