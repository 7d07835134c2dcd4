// COCOeval greedy matching — native backend for eval/coco_map.py (the port's copy of native/cocomatch.cpp).
//
// Native counterpart of the reference's faster-coco-eval C extension
// (reference src/dl/validator.py:52-67 uses faster_coco_eval as the mAP
// backend): the matching scan is inherently sequential over score-sorted
// detections, so it belongs on the host in native code, not in numpy.
// Semantics are the exact pycocotools COCOeval.evaluateImg scan (see
// eval/coco_map.py:_match_image for the rule-by-rule derivation); the Python
// implementation stays as the differential-testing oracle.
//
// One call handles one class: K images x R area-ranges x T thresholds.
// Per-range GT ignore flags, the ignored-last stable GT ordering and the
// n_gt tally are computed here too, so Python does no per-range work at all.
//
// Plain C ABI (ctypes; pybind11 is not in the image).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int coco_match_class(
    const float* ious,       // concat over images: D_k * G_k, row-major [D,G]
    const float* g_areas,    // concat over images: G_k
    const uint8_t* g_crowd,  // concat over images: G_k
    const float* d_areas,    // concat over images: D_k
    const int32_t* dg,       // [K, 2] = (D_k, G_k)
    int32_t K,
    const double* thrs,      // [T] IoU thresholds (ascending not required)
    int32_t T,
    const double* ranges,    // [R, 2] = (area_lo, area_hi), inclusive bounds
    int32_t R,
    uint8_t* tp_out,         // [R, T, D_total]  (D_total = sum_k D_k)
    uint8_t* ig_out,         // [R, T, D_total]
    int32_t* ngt_out         // [R] non-ignored GT count (summed over images)
) {
    int64_t d_total = 0;
    for (int32_t k = 0; k < K; ++k) d_total += dg[2 * k];
    for (int32_t r = 0; r < R; ++r) ngt_out[r] = 0;

    std::vector<int32_t> order;    // GT scan order, ignored-last (stable)
    std::vector<uint8_t> gig;      // ignore flag, in scan order
    std::vector<uint8_t> matched;  // consumed flag, in scan order

    int64_t iou_off = 0, g_off = 0, d_off = 0;
    for (int32_t k = 0; k < K; ++k) {
        const int32_t D = dg[2 * k], G = dg[2 * k + 1];
        const float* iou_k = ious + iou_off;
        const float* ga = g_areas + g_off;
        const uint8_t* crowd = g_crowd + g_off;
        const float* da = d_areas + d_off;

        for (int32_t r = 0; r < R; ++r) {
            const double lo = ranges[2 * r], hi = ranges[2 * r + 1];
            // per-range ignore + stable ignored-last order (COCOeval sorts
            // GTs by ignore flag with a stable sort)
            order.resize(G);
            gig.resize(G);
            int32_t n_real = 0;
            for (int32_t g = 0; g < G; ++g) {
                gig[g] = crowd[g] || ga[g] < lo || ga[g] > hi;
                n_real += !gig[g];
            }
            ngt_out[r] += n_real;
            int32_t at = 0;
            for (int32_t g = 0; g < G; ++g) if (!gig[g]) order[at++] = g;
            for (int32_t g = 0; g < G; ++g) if (gig[g]) order[at++] = g;

            for (int32_t t = 0; t < T; ++t) {
                const double thr = thrs[t];
                uint8_t* tp_row = tp_out + ((int64_t)r * T + t) * d_total + d_off;
                uint8_t* ig_row = ig_out + ((int64_t)r * T + t) * d_total + d_off;
                matched.assign(G, 0);
                for (int32_t d = 0; d < D; ++d) {
                    double best = thr;  // candidate needs iou >= threshold
                    int32_t m = -1;     // position in scan order
                    for (int32_t gi = 0; gi < G; ++gi) {
                        const int32_t g = order[gi];
                        // consumed non-crowd GTs are gone; crowds absorb
                        if (matched[gi] && !crowd[g]) continue;
                        // already matched a real GT and reached the ignored
                        // tail: stop (pycocotools break rule —
                        // gtIg[m]==0 and gtIg[g]==1; scan order is real-first)
                        if (m > -1 && m < n_real && gi >= n_real) break;
                        const double v = (double)iou_k[(int64_t)d * G + g];
                        if (v < best) continue;
                        best = v;  // ties update m: last-among-equals
                        m = gi;
                    }
                    if (m == -1) {
                        // unmatched: FP unless the detection is out of range
                        ig_row[d] = (da[d] < lo || da[d] > hi);
                        continue;
                    }
                    matched[m] = 1;
                    const uint8_t mig = (m >= n_real);  // scan order: real first
                    tp_row[d] = !mig;
                    ig_row[d] = mig;
                }
            }
        }
        iou_off += (int64_t)D * G;
        g_off += G;
        d_off += D;
    }
    return 0;
}
