"""COCO-style mean average precision (pure numpy, COCOeval-faithful).

Replaces the reference's torchmetrics MeanAveragePrecision(faster_coco_eval)
dependency (src/dl/validator.py:52-67,109-127) with a self-contained
implementation of the pycocotools COCOeval protocol:

- per-(class, image) greedy score-ordered matching with the exact COCOeval
  tie-breaks: a detection takes the best-IoU *non-ignored* unmatched GT above
  the threshold; only if none qualifies may it match an ignored/crowd GT
  (COCOeval.evaluateImg's `gtIg[m]==0 and gtIg[gind]==1 -> break` rule);
- crowd GTs (gt["iscrowd"]) can absorb multiple detections and mark them
  ignored (neither TP nor FP);
- area-range buckets (all / small <32^2 / medium / large >96^2): out-of-range
  GTs are ignored, and *unmatched* detections whose area falls outside the
  range are ignored rather than counted as FP;
- maxDets truncation applied per image per category, exactly where
  pycocotools applies it (evaluateImg `dt=dt[0:maxDet]`; note this is
  pycocotools' documented deviation from the paper's "100 per image" — it is
  the number torchmetrics/faster-coco-eval print, which is the parity target);
- 101-point interpolated precision, IoU thresholds 0.50:0.05:0.95, stable
  (mergesort) score ordering, classes with no GT excluded from the mean.

Supports box IoU and mask IoU ("segm"; crowd semantics follow the same
ignore rules, with mask pixel count as the area).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import cocomatch_native

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)

# COCOeval.params.areaRng
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _box_iou(a: np.ndarray, b: np.ndarray,
             b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """a [N,4] dt, b [M,4] gt xyxy -> [N,M]. Crowd GT uses IoA (maskUtils.iou
    `iscrowd` semantics: union = det area)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    if b_crowd is None:
        b_crowd = np.zeros(len(b), bool)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    union = np.where(b_crowd[None, :], area_a[:, None], union)
    safe = np.maximum(union, 1e-12)  # 0-area pairs select the 0 branch
    return np.where(union > 0, inter / safe, 0.0).astype(np.float32)


def _mask_iou(a: np.ndarray, b: np.ndarray,
              b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """a [N,H,W], b [M,H,W] binary -> [N,M]; crowd GT uses IoA."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    if b_crowd is None:
        b_crowd = np.zeros(len(b), bool)
    af = a.reshape(len(a), -1).astype(np.float32)
    bf = b.reshape(len(b), -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    union = np.where(b_crowd[None, :], af.sum(1)[:, None], union)
    safe = np.maximum(union, 1e-12)  # 0-area pairs select the 0 branch
    return np.where(union > 0, inter / safe, 0.0).astype(np.float32)


def _areas(items: np.ndarray, iou_type: str) -> np.ndarray:
    if len(items) == 0:
        return np.zeros((0,), np.float32)
    if iou_type == "segm":
        return items.reshape(len(items), -1).astype(bool).sum(1).astype(np.float32)
    return ((items[:, 2] - items[:, 0]) * (items[:, 3] - items[:, 1])).astype(np.float32)


def _match_image(
    ious: np.ndarray,        # [D, G] detection-major, score-sorted detections
    gt_ignore: np.ndarray,   # [G] bool (crowd or out-of-area-range)
    gt_crowd: np.ndarray,    # [G] bool
    dt_out_of_range: np.ndarray,  # [D] bool
) -> Tuple[np.ndarray, np.ndarray]:
    """COCOeval.evaluateImg matching for all IoU thresholds, vectorized over
    thresholds and GTs (the only true sequential dependency is over
    detections, which consume GTs in score order).

    Exact semantics of the pycocotools scan, proven equal by the fixture
    tests and a randomized differential test (tests/test_validator.py):
    - a detection takes the best-IoU (>= threshold) available GT; among the
      non-ignored GTs if any qualifies (the `gtIg[m]==0 and gtIg[g]==1 ->
      break` rule with GTs sorted non-ignored first), else among ignored;
    - ties on IoU go to the LAST GT in scan order (pycocotools updates `m`
      on `iou >= best`);
    - non-crowd GTs are consumed once; crowd GTs absorb repeatedly.

    Returns (tp [T,D], dt_ig [T,D]). GTs must be ordered non-ignored first
    (COCOeval sorts by ignore flag); `ious` columns follow that order.
    """
    T = len(IOU_THRESHOLDS)
    D, G = ious.shape
    tp = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    if G == 0:
        dt_ig[:] = dt_out_of_range[None, :]
        return tp, dt_ig
    thr = IOU_THRESHOLDS[:, None]                       # [T,1]
    matched = np.zeros((T, G), bool)
    ni = ~gt_ignore
    crowd_row = gt_crowd[None, :]
    for d in range(D):
        row = ious[d][None, :]                          # [1,G]
        ok = (~matched | crowd_row) & (row >= thr)      # [T,G] candidates
        v_ni = np.where(ok & ni[None, :], row, -1.0)
        v_ig = np.where(ok & ~ni[None, :], row, -1.0)
        best_ni = v_ni.max(1)
        use_ni = best_ni > -1.0                         # real match exists
        v = np.where(use_ni[:, None], v_ni, v_ig)
        bestv = np.where(use_ni, best_ni, v_ig.max(1))  # [T]
        have = bestv > -1.0
        # last index among equals (pycocotools tie-break)
        m = G - 1 - np.argmax(v[:, ::-1] == bestv[:, None], axis=1)
        rows = np.flatnonzero(have)
        mm = m[rows]
        matched[rows, mm] = True
        ig_m = gt_ignore[mm]
        tp[rows, d] = ~ig_m                             # match to real GT
        dt_ig[rows, d] = ig_m                           # match to ignored GT
        # unmatched: FP unless the detection itself is out of range
        dt_ig[~have, d] = dt_out_of_range[d]
    return tp, dt_ig


def _ap_from_matches(
    scores: np.ndarray,   # [D]
    tp: np.ndarray,       # [T, D]
    dt_ig: np.ndarray,    # [T, D]
    n_gt: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """101-point interpolated AP and final recall per IoU threshold -> ([T],[T])."""
    T = tp.shape[0]
    if n_gt == 0:
        return np.full((T,), np.nan), np.full((T,), np.nan)
    order = np.argsort(-scores, kind="mergesort")
    tp = tp[:, order]
    dt_ig = dt_ig[:, order]
    aps = np.zeros((T,))
    recs = np.zeros((T,))
    for t in range(T):
        keep = ~dt_ig[t]
        m = tp[t][keep]
        if len(m) == 0:
            continue  # no (non-ignored) detections: AP and recall stay 0
        tps = np.cumsum(m)
        fps = np.cumsum(~m)
        recall = tps / n_gt
        precision = tps / np.maximum(tps + fps, 1e-12)
        recs[t] = recall[-1] if len(recall) else 0.0
        pr = precision[::-1]
        pr = np.maximum.accumulate(pr)[::-1]
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        q = np.where(idx < len(pr), pr[np.minimum(idx, max(len(pr) - 1, 0))], 0.0)
        aps[t] = q.mean() if len(pr) else 0.0
    return aps, recs


def coco_map(
    preds: List[Dict],
    gts: List[Dict],
    iou_type: str = "bbox",
    max_dets: int = 100,
    area_ranges: Optional[Sequence[str]] = ("all", "small", "medium", "large"),
    native: Optional[bool] = None,
) -> Dict[str, float]:
    """preds/gts: per-image dicts with 'labels' [N], 'scores' [N] (preds only),
    'boxes' [N,4] xyxy (iou_type='bbox') or 'masks' [N,H,W] (iou_type='segm'),
    and optional gt 'iscrowd' [N] bool.

    Returns {"map", "map_50", "map_75", "map_small", "map_medium",
    "map_large", "mar_100"} (area buckets only for the ranges requested).
    """
    assert len(preds) == len(gts)
    key = "masks" if iou_type == "segm" else "boxes"
    iou_fn = _mask_iou if iou_type == "segm" else _box_iou
    T = len(IOU_THRESHOLDS)

    classes = set()
    for g in gts:
        classes.update(np.asarray(g["labels"]).astype(int).tolist())
    for p in preds:
        classes.update(np.asarray(p["labels"]).astype(int).tolist())
    area_ranges = list(area_ranges or ["all"])
    if "all" not in area_ranges:
        area_ranges = ["all"] + area_ranges

    # ap[range][class] = [T]; rec likewise
    ap: Dict[str, List[np.ndarray]] = {r: [] for r in area_ranges}
    rec: Dict[str, List[np.ndarray]] = {r: [] for r in area_ranges}

    if native is None:
        native = cocomatch_native.available()
    range_bounds = [AREA_RANGES[r] for r in area_ranges]

    for cls in sorted(classes):
        # per-image glue + IoU ONCE per (image, class); matching over ranges x
        # thresholds runs in the native backend (or the numpy oracle below)
        img_scores, img_ious, img_ga, img_crowd, img_da = [], [], [], [], []
        for p, g in zip(preds, gts):
            gl = np.asarray(g["labels"]).astype(int)
            pl = np.asarray(p["labels"]).astype(int)
            g_sel = np.flatnonzero(gl == cls)
            p_sel = np.flatnonzero(pl == cls)

            ps = np.asarray(p["scores"])[p_sel]
            order = np.argsort(-ps, kind="mergesort")[:max_dets]
            p_sel = p_sel[order]
            ps = ps[order]

            p_items = np.asarray(p[key])[p_sel]
            g_items = (np.asarray(g[key])[g_sel] if len(g_sel)
                       else np.zeros((0,) + np.asarray(p[key]).shape[1:]))
            crowd = (np.asarray(g.get("iscrowd"))[g_sel].astype(bool)
                     if g.get("iscrowd") is not None and len(g_sel)
                     else np.zeros(len(g_sel), bool))
            img_scores.append(ps)
            img_ga.append(_areas(g_items, iou_type))
            img_da.append(_areas(p_items, iou_type))
            img_crowd.append(crowd)
            # crowd IoA semantics are range-independent
            img_ious.append(iou_fn(p_items, g_items, crowd))

        scores = (np.concatenate(img_scores) if img_scores
                  else np.zeros((0,)))
        if native:
            tp_all, ig_all, ngt = cocomatch_native.match_class(
                img_ious, img_ga, img_crowd, img_da,
                IOU_THRESHOLDS, range_bounds)
            for ri, rname in enumerate(area_ranges):
                a, r = _ap_from_matches(scores, tp_all[ri], ig_all[ri],
                                        int(ngt[ri]))
                ap[rname].append(a)
                rec[rname].append(r)
            continue

        for ri, rname in enumerate(area_ranges):
            lo, hi = range_bounds[ri]
            tp_l, ig_l, n_gt = [], [], 0
            for ious_base, g_areas, crowd, d_areas in zip(
                    img_ious, img_ga, img_crowd, img_da):
                g_ig = crowd | (g_areas < lo) | (g_areas > hi)
                # COCOeval sorts GTs ignored-last
                g_order = np.argsort(g_ig, kind="mergesort")
                d_oor = (d_areas < lo) | (d_areas > hi)
                tp_i, ig_i = _match_image(
                    ious_base[:, g_order], g_ig[g_order], crowd[g_order], d_oor)
                tp_l.append(tp_i)
                ig_l.append(ig_i)
                n_gt += int((~g_ig).sum())
            tp = (np.concatenate(tp_l, axis=1) if tp_l
                  else np.zeros((T, 0), bool))
            ig = (np.concatenate(ig_l, axis=1) if ig_l
                  else np.zeros((T, 0), bool))
            a, r = _ap_from_matches(scores, tp, ig, n_gt)
            ap[rname].append(a)
            rec[rname].append(r)

    def _mean(arr_list, t_slice=slice(None), empty=0.0):
        if not arr_list:
            return empty
        arr = np.stack(arr_list)[:, t_slice]
        valid = arr[~np.isnan(arr)]
        return empty if valid.size == 0 else float(valid.mean())

    out = {
        "map": _mean(ap["all"]),
        "map_50": _mean(ap["all"], slice(0, 1)),
        "map_75": _mean(ap["all"], slice(5, 6)),
        "mar_100": _mean(rec["all"]),
    }
    for rname in area_ranges:
        if rname != "all":
            # COCOeval convention: -1 when the bucket has no ground truth
            out[f"map_{rname}"] = _mean(ap[rname], empty=-1.0)
    return out
