"""Letterbox / resize preprocessing with the reference's exact rounding.

Parity target: reference src/dl/utils.py:809-1003 (LetterboxRect) — the
±0.1 border rounding must match between training and inference, and the same
function is reused by the serving path so train/infer preprocessing are
bit-identical (the reference keeps two copies: albumentations transform +
torch_model.py:240-264).
"""

from __future__ import annotations

from typing import Dict, Tuple

import cv2
import numpy as np


def letterbox_params(
    orig_h: int, orig_w: int, target_h: int, target_w: int, scaleup: bool = True
) -> Dict[str, float]:
    """Compute resize + pad geometry (reference dl/utils.py:840-898)."""
    r = min(target_h / orig_h, target_w / orig_w)
    if not scaleup:
        r = min(r, 1.0)
    new_w = int(round(orig_w * r))
    new_h = int(round(orig_h * r))
    dw = (target_w - new_w) * 0.5
    dh = (target_h - new_h) * 0.5
    return {
        "ratio": r,
        "new_w": new_w,
        "new_h": new_h,
        "pad_left": int(round(dw - 0.1)),
        "pad_right": int(round(dw + 0.1)),
        "pad_top": int(round(dh - 0.1)),
        "pad_bottom": int(round(dh + 0.1)),
    }


def letterbox_image(
    img: np.ndarray, target_h: int, target_w: int,
    color: Tuple[int, int, int] = (114, 114, 114), scaleup: bool = True,
) -> Tuple[np.ndarray, Dict[str, float]]:
    p = letterbox_params(img.shape[0], img.shape[1], target_h, target_w, scaleup)
    out = img
    if img.shape[1] != p["new_w"] or img.shape[0] != p["new_h"]:
        out = cv2.resize(img, (p["new_w"], p["new_h"]), interpolation=cv2.INTER_LINEAR)
    if p["pad_top"] or p["pad_bottom"] or p["pad_left"] or p["pad_right"]:
        out = cv2.copyMakeBorder(
            out, p["pad_top"], p["pad_bottom"], p["pad_left"], p["pad_right"],
            cv2.BORDER_CONSTANT, value=color,
        )
    return out, p


def letterbox_mask(mask: np.ndarray, p: Dict[str, float]) -> np.ndarray:
    """Masks: bilinear resize + 0.5 re-threshold, zero padding (reference :922-947)."""
    out = mask
    if mask.shape[1] != p["new_w"] or mask.shape[0] != p["new_h"]:
        m = cv2.resize(mask.astype(np.float32), (p["new_w"], p["new_h"]),
                       interpolation=cv2.INTER_LINEAR)
        out = (m > 0.5).astype(mask.dtype)
    if p["pad_top"] or p["pad_bottom"] or p["pad_left"] or p["pad_right"]:
        out = cv2.copyMakeBorder(
            out, p["pad_top"], p["pad_bottom"], p["pad_left"], p["pad_right"],
            cv2.BORDER_CONSTANT, value=0,
        )
    return out


def letterbox_boxes_abs(boxes_xyxy: np.ndarray, p: Dict[str, float]) -> np.ndarray:
    """Map abs-xyxy boxes from the original image into letterboxed canvas."""
    if len(boxes_xyxy) == 0:
        return boxes_xyxy.astype(np.float32)
    b = boxes_xyxy.astype(np.float32).copy()
    b[:, [0, 2]] = b[:, [0, 2]] * p["ratio"] + p["pad_left"]
    b[:, [1, 3]] = b[:, [1, 3]] * p["ratio"] + p["pad_top"]
    return b


def unletterbox_boxes_abs(
    boxes_xyxy: np.ndarray, p: Dict[str, float], orig_h: int, orig_w: int
) -> np.ndarray:
    """Map abs-xyxy boxes on the letterboxed canvas back to original image
    (reference dl/utils.py process_boxes semantics)."""
    if len(boxes_xyxy) == 0:
        return boxes_xyxy.astype(np.float32)
    b = boxes_xyxy.astype(np.float32).copy()
    b[:, [0, 2]] = (b[:, [0, 2]] - p["pad_left"]) / p["ratio"]
    b[:, [1, 3]] = (b[:, [1, 3]] - p["pad_top"]) / p["ratio"]
    b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, orig_w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, orig_h)
    return b


def plain_resize(
    img: np.ndarray, target_h: int, target_w: int
) -> Tuple[np.ndarray, Dict[str, float]]:
    """keep_ratio=False path: plain bilinear resize (reference dataset.py:126)."""
    h, w = img.shape[:2]
    out = cv2.resize(img, (target_w, target_h), interpolation=cv2.INTER_LINEAR)
    return out, {
        "ratio": None, "ratio_x": target_w / w, "ratio_y": target_h / h,
        "new_w": target_w, "new_h": target_h,
        "pad_left": 0, "pad_right": 0, "pad_top": 0, "pad_bottom": 0,
    }
