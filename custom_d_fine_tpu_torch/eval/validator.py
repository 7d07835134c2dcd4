"""Validator: greedy-matching F1/P/R/IoU + confusion matrix + COCO mAP + plots.

Parity target: reference src/dl/validator.py:21-659. Differences by design:
- pure numpy (no torch / torchmetrics); mAP via eval/coco_map.py;
- mask RLE decode via eval/rle.py.

Input format (same as the reference):
  gt   = [{"labels": [N], "boxes": [N,4] xyxy abs, ["masks"|"masks_rle"]}, ...]
  preds = same + "scores"; optional "all_boxes"/"all_labels"/"all_scores"
  (unfiltered arrays used for mAP, reference validator.py:58-67).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

from .coco_map import _box_iou, _mask_iou, coco_map
from .rle import rle_to_masks


def filter_preds_by_conf(preds: List[Dict], conf: float) -> List[Dict]:
    """Score-threshold filtering keeping masks in sync
    (reference dl/utils.py:417-465 filter_preds)."""
    out = []
    for p in preds:
        keep = np.asarray(p["scores"]) >= conf
        q = {}
        for k, v in p.items():
            if k.startswith("all_") or k == "masks_rle":
                q[k] = v
            elif k == "masks" and v is not None and len(v):
                q[k] = np.asarray(v)[keep]
            elif isinstance(v, np.ndarray) and v.shape[:1] == keep.shape:
                q[k] = v[keep]
            else:
                q[k] = v
        if "masks_rle" in p and p["masks_rle"]:
            q["masks_rle"] = [r for r, k in zip(p["masks_rle"], keep) if k]
        out.append(q)
    return out


def _sample_masks(sample: Dict) -> np.ndarray:
    if sample.get("masks") is not None and len(np.asarray(sample.get("masks", []))):
        m = np.asarray(sample["masks"])
        if m.ndim == 4 and m.shape[1] == 1:
            m = m[:, 0]
        return (m > 0.5).astype(np.uint8)
    if sample.get("masks_rle"):
        return rle_to_masks(sample["masks_rle"])
    return np.zeros((0, 1, 1), np.uint8)


def _has_masks(sample: Dict) -> bool:
    if sample.get("masks") is not None and len(np.asarray(sample.get("masks", []))) > 0:
        return True
    return bool(sample.get("masks_rle"))


class Validator:
    def __init__(
        self,
        gt: List[Dict],
        preds: List[Dict],
        label_to_name: Dict[int, str],
        conf_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        compute_maps: bool = True,
    ):
        def _norm(sample):
            out = {}
            for k, v in sample.items():
                if k == "masks_rle":  # list of RLE dicts — keep as-is
                    out[k] = v
                elif isinstance(v, (list, np.ndarray)) or hasattr(v, "shape"):
                    out[k] = np.asarray(v)
                else:
                    out[k] = v
            return out

        self.gt = [_norm(g) for g in gt]
        self.preds = [_norm(p) for p in preds]
        self.label_to_name = label_to_name
        self.conf_thresh = conf_thresh
        self.iou_thresh = iou_thresh
        self.thresholds = np.arange(0.2, 1.0, 0.05)
        self.compute_maps = compute_maps
        self.conf_matrix = None
        self.class_to_idx = None
        self.metrics_per_class = None
        self.use_masks = any(_has_masks(p) for p in self.preds) and any(
            _has_masks(g) for g in self.gt
        )

    # ------------------------------ main metrics ------------------------------

    def compute_metrics(self, extended: bool = False, ignore_masks: bool = False) -> Dict:
        metrics = self._compute_main_metrics(self.preds, ignore_masks=ignore_masks)

        if self.compute_maps:
            # mAP uses the unfiltered arrays when provided (reference :58-67)
            tm_preds = []
            for p in self.preds:
                q = dict(p)
                if "all_boxes" in p:
                    q["boxes"], q["labels"], q["scores"] = (
                        p["all_boxes"], p["all_labels"], p["all_scores"]
                    )
                tm_preds.append(q)
            # the Validator reports only map/map_50 — skip the S/M/L buckets
            # (4x less matching work per eval epoch on this 1-core host)
            m = coco_map(tm_preds, self.gt, iou_type="bbox",
                         area_ranges=("all",))
            metrics["mAP_50"] = m["map_50"]
            metrics["mAP_50_95"] = m["map"]
            if self.use_masks and not ignore_masks:
                seg_preds = [
                    {"labels": p["labels"], "scores": p["scores"], "masks": _sample_masks(p)}
                    for p in self.preds
                ]
                seg_gt = [
                    {"labels": g["labels"], "masks": _sample_masks(g)} for g in self.gt
                ]
                mm = coco_map(seg_preds, seg_gt, iou_type="segm",
                              area_ranges=("all",))
                metrics["mAP_50_mask"] = mm["map_50"]
                metrics["mAP_50_95_mask"] = mm["map"]
                metrics["extended_metrics"].update({
                    "mAP_50_95_mask": metrics["mAP_50_95_mask"],
                    "mAP_50_95": metrics["mAP_50_95"],
                })

        if not extended:
            metrics.pop("extended_metrics", None)
        return metrics

    def _compute_main_metrics(self, preds, ignore_masks=False):
        self.metrics_per_class, self.conf_matrix, self.class_to_idx = (
            self._match(preds, ignore_masks=ignore_masks)
        )
        tps = fps = fns = 0
        ious = []
        ext = {}
        for key, v in self.metrics_per_class.items():
            tps += v["TPs"]
            fps += v["FPs"]
            fns += v["FNs"]
            ious.extend(v["IoUs"])
            name = self.label_to_name.get(key, str(key))
            p = v["TPs"] / (v["TPs"] + v["FPs"]) if v["TPs"] + v["FPs"] > 0 else 0
            r = v["TPs"] / (v["TPs"] + v["FNs"]) if v["TPs"] + v["FNs"] > 0 else 0
            ext[f"precision_{name}"] = p
            ext[f"recall_{name}"] = r
            ext[f"iou_{name}"] = float(np.mean(v["IoUs"])) if v["IoUs"] else 0.0
            ext[f"f1_{name}"] = 2 * p * r / (p + r) if (p + r) > 0 else 0

        precision = tps / (tps + fps) if tps + fps > 0 else 0
        recall = tps / (tps + fns) if tps + fns > 0 else 0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0
        return {
            "f1": f1, "precision": precision, "recall": recall,
            "iou": float(np.mean(ious)) if ious else 0,
            "TPs": tps, "FPs": fps, "FNs": fns,
            "extended_metrics": ext,
        }

    # ------------------------------ matching ----------------------------------

    def _match(self, preds, ignore_masks):
        """Greedy IoU-sorted 1:1 matching per image (reference :354-451 for
        boxes, :453-569 for masks); returns (per-class metrics, confusion
        matrix with background row/col, class index map)."""
        use_masks = self.use_masks and not ignore_masks

        metrics = defaultdict(lambda: {"TPs": 0, "FPs": 0, "FNs": 0, "IoUs": []})
        all_classes = set()
        for p in preds:
            all_classes.update(np.asarray(p["labels"]).astype(int).tolist())
        for g in self.gt:
            all_classes.update(np.asarray(g["labels"]).astype(int).tolist())
        all_classes = sorted(all_classes)
        class_to_idx = {c: i for i, c in enumerate(all_classes)}
        n_cls = len(all_classes)
        conf = np.zeros((n_cls + 1, n_cls + 1), int)

        for p, g in zip(preds, self.gt):
            pl = np.asarray(p["labels"]).astype(int)
            gl = np.asarray(g["labels"]).astype(int)

            if use_masks:
                pm = _sample_masks(p)
                gm = _sample_masks(g)
                n_p, n_g = len(pm), len(gm)
                if n_p and n_g and pm.shape[-2:] != gm.shape[-2:]:
                    import cv2

                    pm = np.stack([
                        (cv2.resize(m.astype(np.float32), (gm.shape[-1], gm.shape[-2]),
                                    interpolation=cv2.INTER_LINEAR) > 0.5).astype(np.uint8)
                        for m in pm
                    ]) if n_p else pm
                ious = _mask_iou(pm, gm) if n_p and n_g else np.zeros((n_p, n_g))
            else:
                pb = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
                gb = np.asarray(g["boxes"], np.float32).reshape(-1, 4)
                n_p, n_g = len(pb), len(gb)
                ious = _box_iou(pb, gb)

            if n_p == 0 and n_g == 0:
                continue

            matched_p, matched_g = set(), set()
            if ious.size:
                pi, gi = np.nonzero(ious >= self.iou_thresh)
                vals = ious[pi, gi]
                order = np.argsort(-vals, kind="stable")
                for k in order:
                    a, b = int(pi[k]), int(gi[k])
                    if a in matched_p or b in matched_g:
                        continue
                    matched_p.add(a)
                    matched_g.add(b)
                    p_lab, g_lab = int(pl[a]), int(gl[b])
                    conf[class_to_idx[g_lab], class_to_idx[p_lab]] += 1
                    if p_lab == g_lab:
                        metrics[g_lab]["TPs"] += 1
                        metrics[g_lab]["IoUs"].append(float(vals[k]))
                    else:
                        metrics[g_lab]["FNs"] += 1
                        metrics[p_lab]["FPs"] += 1
                        metrics[g_lab]["IoUs"].append(0.0)
                        metrics[p_lab]["IoUs"].append(0.0)

            for a in set(range(n_p)) - matched_p:
                lab = int(pl[a])
                conf[n_cls, class_to_idx[lab]] += 1
                metrics[lab]["FPs"] += 1
                metrics[lab]["IoUs"].append(0.0)
            for b in set(range(n_g)) - matched_g:
                lab = int(gl[b])
                conf[class_to_idx[lab], n_cls] += 1
                metrics[lab]["FNs"] += 1
                metrics[lab]["IoUs"].append(0.0)

        return metrics, conf, class_to_idx

    # ------------------------------ plots --------------------------------------

    def save_plots(self, path_to_save) -> None:
        """Confusion matrix, P/R vs threshold, F1 vs threshold + best-threshold
        report (reference :571-659)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        path_to_save = Path(path_to_save)
        path_to_save.mkdir(parents=True, exist_ok=True)

        if self.conf_matrix is not None:
            # class NAMES on the axes (reference validator.py renders names)
            labels = [self.label_to_name.get(c, str(c))
                      for c in self.class_to_idx] + ["background"]
            plt.figure(figsize=(10, 8))
            plt.imshow(self.conf_matrix, interpolation="nearest", cmap=plt.cm.Blues)
            plt.title("Confusion Matrix")
            plt.colorbar()
            ticks = np.arange(len(labels))
            plt.xticks(ticks, labels, rotation=45)
            plt.yticks(ticks, labels)
            thresh = self.conf_matrix.max() / 2.0
            for i in range(self.conf_matrix.shape[0]):
                for j in range(self.conf_matrix.shape[1]):
                    plt.text(j, i, str(self.conf_matrix[i, j]), ha="center",
                             color="white" if self.conf_matrix[i, j] > thresh else "black")
            plt.ylabel("True label")
            plt.xlabel("Predicted label")
            plt.tight_layout()
            plt.savefig(path_to_save / "confusion_matrix.png")
            plt.close()

        precisions, recalls, f1s = [], [], []
        for thr in self.thresholds:
            filtered = filter_preds_by_conf(copy.deepcopy(self.preds), thr)
            m = self._compute_main_metrics(filtered, ignore_masks=True)
            precisions.append(m["precision"])
            recalls.append(m["recall"])
            f1s.append(m["f1"])

        plt.figure()
        plt.plot(self.thresholds, precisions, label="Precision", marker="o")
        plt.plot(self.thresholds, recalls, label="Recall", marker="o")
        plt.xlabel("Threshold")
        plt.ylabel("Value")
        plt.title("Precision and Recall vs Threshold")
        plt.legend()
        plt.grid(True)
        plt.savefig(path_to_save / "precision_recall_vs_threshold.png")
        plt.close()

        plt.figure()
        plt.plot(self.thresholds, f1s, label="F1 Score", marker="o")
        plt.xlabel("Threshold")
        plt.ylabel("F1 Score")
        plt.title("F1 Score vs Threshold")
        plt.grid(True)
        plt.savefig(path_to_save / "f1_score_vs_threshold.png")
        plt.close()

        best_idx = len(f1s) - int(np.argmax(f1s[::-1])) - 1
        self.best_threshold = float(self.thresholds[best_idx])
        self.best_f1 = float(f1s[best_idx])
        print(f"Best threshold: {self.best_threshold:.2f} (F1 {self.best_f1:.3f})")
