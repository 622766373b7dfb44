// Run-length mask ops and COCOeval's greedy matching on the host (the port's
// own copy of u2seg_tpu/_native/rle_ops.cpp, same seven entry points).
//
// pycocotools' C maskApi (rleArea/rleIou/rleMerge/rleEncode/rleDecode) and
// detectron2's csrc/cocoeval/cocoeval.cpp (COCOevalEvaluateImages per-image
// greedy matching) behind a plain C ABI, loaded with ctypes by
// u2seg_torch/_native/__init__.py, which builds it with -ffp-contract=off so
// that no fused multiply-add rounds otherwise than numpy. The numpy twins
// (evaluation/rle.py::_iou_plain, coco_eval_core.py::_bbox_iou_xywh and
// ::_match_plain) define the semantics.
//
// RLE convention: column-major (Fortran) runs, counts[0] is the leading
// background run (may be 0), runs alternate 0/1.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RLE primitives
// ---------------------------------------------------------------------------

// decode counts -> (h*w) column-major uint8 buffer
void rle_decode(const uint32_t* counts, int m, uint8_t* out, int64_t hw) {
  int64_t pos = 0;
  uint8_t v = 0;
  for (int i = 0; i < m && pos < hw; i++) {
    int64_t run = counts[i];
    if (run > hw - pos) run = hw - pos;
    if (v) memset(out + pos, 1, run);
    else memset(out + pos, 0, run);
    pos += run;
    v = !v;
  }
  if (pos < hw) memset(out + pos, 0, hw - pos);
}

// encode column-major uint8 buffer -> counts; returns run count.
// counts_out must have room for hw+1 entries.
int rle_encode(const uint8_t* mask, int64_t hw, uint32_t* counts_out) {
  int m = 0;
  uint8_t cur = 0;  // first run counts zeros
  uint32_t run = 0;
  for (int64_t i = 0; i < hw; i++) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v == cur) {
      run++;
    } else {
      counts_out[m++] = run;
      cur = v;
      run = 1;
    }
  }
  counts_out[m++] = run;
  return m;
}

double rle_area(const uint32_t* counts, int m) {
  double a = 0;
  for (int i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// intersection area of two RLEs by merge-walking the run lists
static double rle_intersection(const uint32_t* a, int ma, const uint32_t* b,
                               int mb) {
  double inter = 0;
  int ia = 0, ib = 0;
  uint64_t ca = ma > 0 ? a[0] : 0, cb = mb > 0 ? b[0] : 0;
  bool va = false, vb = false;
  while (ia < ma && ib < mb) {
    if (ca == 0) {
      ia++;
      if (ia < ma) ca = a[ia];
      va = !va;
      continue;
    }
    if (cb == 0) {
      ib++;
      if (ib < mb) cb = b[ib];
      vb = !vb;
      continue;
    }
    uint64_t step = ca < cb ? ca : cb;
    if (va && vb) inter += (double)step;
    ca -= step;
    cb -= step;
  }
  return inter;
}

// IoU matrix between D dt RLEs and G gt RLEs.
// counts are concatenated; offsets give [start, end) per mask.
void rle_iou_matrix(const uint32_t* dt_counts, const int64_t* dt_off, int D,
                    const uint32_t* gt_counts, const int64_t* gt_off, int G,
                    const uint8_t* iscrowd, double* out /*D*G*/) {
  std::vector<double> dt_area(D), gt_area(G);
  for (int i = 0; i < D; i++)
    dt_area[i] = rle_area(dt_counts + dt_off[i], (int)(dt_off[i + 1] - dt_off[i]));
  for (int j = 0; j < G; j++)
    gt_area[j] = rle_area(gt_counts + gt_off[j], (int)(gt_off[j + 1] - gt_off[j]));
  for (int i = 0; i < D; i++) {
    for (int j = 0; j < G; j++) {
      double inter = rle_intersection(
          dt_counts + dt_off[i], (int)(dt_off[i + 1] - dt_off[i]),
          gt_counts + gt_off[j], (int)(gt_off[j + 1] - gt_off[j]));
      double denom = iscrowd[j] ? dt_area[i]
                                : dt_area[i] + gt_area[j] - inter;
      out[i * G + j] = denom > 0 ? inter / denom : 0.0;
    }
  }
}

// merge (union or intersection) of N RLEs into a dense buffer
void rle_merge(const uint32_t* counts, const int64_t* off, int n, int64_t hw,
               int intersect, uint8_t* out) {
  if (n == 0) {
    memset(out, 0, hw);
    return;
  }
  rle_decode(counts + off[0], (int)(off[1] - off[0]), out, hw);
  std::vector<uint8_t> tmp(hw);
  for (int i = 1; i < n; i++) {
    rle_decode(counts + off[i], (int)(off[i + 1] - off[i]), tmp.data(), hw);
    if (intersect)
      for (int64_t j = 0; j < hw; j++) out[j] = out[j] & tmp[j];
    else
      for (int64_t j = 0; j < hw; j++) out[j] = out[j] | tmp[j];
  }
}

// XYWH bbox IoU matrix with crowd handling (maskApi bbIou semantics)
void bbox_iou_matrix(const double* dt /*D*4*/, int D, const double* gt /*G*4*/,
                     int G, const uint8_t* iscrowd, double* out) {
  for (int j = 0; j < G; j++) {
    double gx = gt[j * 4], gy = gt[j * 4 + 1], gw = gt[j * 4 + 2],
           gh = gt[j * 4 + 3];
    double ga = gw * gh;
    for (int i = 0; i < D; i++) {
      double dx = dt[i * 4], dy = dt[i * 4 + 1], dw = dt[i * 4 + 2],
             dh = dt[i * 4 + 3];
      double da = dw * dh;
      double w = std::min(dx + dw, gx + gw) - std::max(dx, gx);
      double h = std::min(dy + dh, gy + gh) - std::max(dy, gy);
      double o = 0;
      if (w > 0 && h > 0) {
        double inter = w * h;
        double u = iscrowd[j] ? da : da + ga - inter;
        o = u > 0 ? inter / u : 0;
      }
      out[i * G + j] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// COCOeval per-image greedy matching (cocoeval.cpp MatchDetectionsToGround-
// Truth equivalent). gts must be pre-sorted (ignored last), dts score-desc.
//
// ious: D x G (already column-permuted to the sorted gt order)
// outputs: dtm (T x D) matched gt index +1 (0 = unmatched),
//          gtm (T x G), dt_ignore (T x D) 0/1
// ---------------------------------------------------------------------------
void cocoeval_match(const double* ious, int D, int G, const uint8_t* gt_ignore,
                    const uint8_t* iscrowd, const double* iou_thrs, int T,
                    const uint8_t* dt_out_of_area, int64_t* dtm, int64_t* gtm,
                    uint8_t* dt_ignore) {
  for (int t = 0; t < T; t++) {
    double thr = iou_thrs[t];
    int64_t* dtm_t = dtm + (int64_t)t * D;
    int64_t* gtm_t = gtm + (int64_t)t * G;
    uint8_t* dti_t = dt_ignore + (int64_t)t * D;
    for (int g = 0; g < G; g++) gtm_t[g] = 0;
    for (int d = 0; d < D; d++) {
      double iou = thr < (1 - 1e-10) ? thr : (1 - 1e-10);
      int m = -1;
      for (int g = 0; g < G; g++) {
        if (gtm_t[g] > 0 && !iscrowd[g]) continue;
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        double v = ious[(int64_t)d * G + g];
        if (v < iou) continue;
        iou = v;
        m = g;
      }
      if (m == -1) {
        dtm_t[d] = 0;
        dti_t[d] = dt_out_of_area[d];
      } else {
        dtm_t[d] = m + 1;
        gtm_t[m] = d + 1;
        dti_t[d] = gt_ignore[m];
      }
    }
  }
}

}  // extern "C"
