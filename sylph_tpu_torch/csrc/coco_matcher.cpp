// Greedy detection-to-GT matcher — the hot inner loop of the COCO AP
// protocol, as a native kernel (the role pycocotools' C _mask extension
// plays for the reference's evaluators, SURVEY.md §2.3).
//
// The port's copy of sylph_tpu/csrc/coco_matcher.cpp. Its plain twin is
// evaluation/coco_eval_np.py::match_greedy_reference:
// for each IoU threshold, detections in score order greedily take the
// best still-available GT (crowd GTs can be matched repeatedly); once a
// real match exists, ignored GTs no longer improve it.
//
// Built by evaluation/_native.py (g++ -O3 -shared -fPIC) into
// sylph_tpu_torch/_build/ and bound with ctypes; a failed build raises.

#include <cstdint>

extern "C" {

// ious:      nd x ng row-major
// g_ignore:  ng (0/1)
// g_crowd:   ng (0/1)
// iou_thrs:  T
// out_dt_m:  T x nd  matched gt index, -1 if none     (int64)
// out_dt_ig: T x nd  matched-to-ignored flag (0/1)    (uint8)
void match_greedy(const double* ious, const uint8_t* g_ignore,
                  const uint8_t* g_crowd, const double* iou_thrs,
                  int64_t T, int64_t nd, int64_t ng,
                  int64_t* out_dt_m, uint8_t* out_dt_ig) {
    // per-threshold gt occupancy
    int64_t* gt_m = new int64_t[ng];
    for (int64_t ti = 0; ti < T; ++ti) {
        for (int64_t g = 0; g < ng; ++g) gt_m[g] = -1;
        const double t = iou_thrs[ti];
        for (int64_t d = 0; d < nd; ++d) {
            double best = t < (1.0 - 1e-10) ? t : (1.0 - 1e-10);
            int64_t best_g = -1;
            const double* row = ious + d * ng;
            for (int64_t g = 0; g < ng; ++g) {
                if (gt_m[g] >= 0 && !g_crowd[g]) continue;
                if (best_g > -1 && !g_ignore[best_g] && g_ignore[g]) break;
                if (row[g] < best) continue;
                best = row[g];
                best_g = g;
            }
            out_dt_m[ti * nd + d] = best_g;
            if (best_g >= 0) {
                out_dt_ig[ti * nd + d] = g_ignore[best_g];
                gt_m[best_g] = d;
            } else {
                out_dt_ig[ti * nd + d] = 0;
            }
        }
    }
    delete[] gt_m;
}

}  // extern "C"
