"""Visualization helpers: draw GT/pred boxes + masks on images.

Parity target: reference src/dl/utils.py:468-621 (visualize, vis_one_box).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import cv2
import numpy as np

_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def class_color(cls_id: int):
    return _PALETTE[int(cls_id) % len(_PALETTE)]


def vis_one_box(img: np.ndarray, box, cls_id: int, score: Optional[float] = None,
                mode: str = "pred", label_to_name: Optional[Dict[int, str]] = None):
    x1, y1, x2, y2 = (int(v) for v in box[:4])
    color = class_color(cls_id) if mode == "pred" else (0, 255, 0)
    cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
    name = (label_to_name or {}).get(int(cls_id), str(int(cls_id)))
    text = f"{name} {score:.2f}" if score is not None else name
    cv2.putText(img, text, (x1, max(y1 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                color, 1, cv2.LINE_AA)


def draw_detections(
    img_bgr: np.ndarray,
    dets: Dict[str, np.ndarray],
    label_to_name: Optional[Dict[int, str]] = None,
    mode: str = "pred",
) -> np.ndarray:
    out = img_bgr.copy()
    masks = dets.get("masks")
    if masks is not None:
        for m, c in zip(masks, dets["labels"]):
            color = np.asarray(class_color(c), np.uint8)
            overlay = out.copy()
            overlay[m > 0] = color
            out = cv2.addWeighted(out, 0.6, overlay, 0.4, 0)
    scores = dets.get("scores")
    for i, (box, cls_id) in enumerate(zip(dets["boxes"], dets["labels"])):
        s = float(scores[i]) if scores is not None else None
        vis_one_box(out, box, cls_id, s, mode, label_to_name)
    return out


def save_gt_pred_pair(img_bgr, gt, pred, path: Path, label_to_name=None):
    """Side-by-side GT | prediction render (reference train.py:418-426)."""
    left = draw_detections(img_bgr, gt, label_to_name, mode="gt")
    right = draw_detections(img_bgr, pred, label_to_name, mode="pred")
    combo = np.concatenate([left, right], axis=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), combo)
