"""YOLO-format label parsing and coordinate conversions.

Parity target: reference src/dl/dataset.py:31-73 (parse_yolo_label_file:
5-column detection rows, >=7-column polygon rows with bbox from polygon
extents, odd-coordinate recovery) and src/dl/utils.py:160-193 (converters).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
from ..utils.logging import logger


def parse_yolo_label_file(path: Path) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Returns (boxes_norm [N,5] = [cls, xc, yc, w, h], polys_norm list of (K,2))."""
    boxes_norm = []
    polys_norm: List[np.ndarray] = []
    with open(path, "r") as f:
        for ln, raw in enumerate(f, 1):
            s = raw.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            cl = float(parts[0])
            nums = [float(x) for x in parts[1:]]
            if len(nums) == 4:
                boxes_norm.append([cl, *nums])
                polys_norm.append(np.empty((0, 2), dtype=np.float32))
            elif len(nums) >= 6:
                if len(nums) % 2 == 1:
                    nums = nums[:-1]
                    logger.warning(
                        f"Odd number of polygon coords at {path}:{ln}; dropping last value."
                    )
                poly = np.asarray(nums, np.float32).reshape(-1, 2)
                polys_norm.append(poly)
                x_min, y_min = poly.min(axis=0)
                x_max, y_max = poly.max(axis=0)
                boxes_norm.append(
                    [cl, (x_min + x_max) / 2, (y_min + y_max) / 2, x_max - x_min, y_max - y_min]
                )
            else:
                raise ValueError(f"Invalid label line {path}:{ln}: {s}")
    if not boxes_norm:
        return np.zeros((0, 5), np.float32), []
    return np.asarray(boxes_norm, np.float32), polys_norm


def norm_xywh_to_abs_xyxy(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N,4] normalized cxcywh -> absolute xyxy."""
    out = np.empty_like(boxes, dtype=np.float32)
    cx, cy, bw, bh = boxes[:, 0] * w, boxes[:, 1] * h, boxes[:, 2] * w, boxes[:, 3] * h
    out[:, 0] = cx - bw / 2
    out[:, 1] = cy - bh / 2
    out[:, 2] = cx + bw / 2
    out[:, 3] = cy + bh / 2
    return out


def abs_xyxy_to_norm_cxcywh(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.empty_like(boxes, dtype=np.float32)
    out[:, 0] = (boxes[:, 0] + boxes[:, 2]) / 2 / w
    out[:, 1] = (boxes[:, 1] + boxes[:, 3]) / 2 / h
    out[:, 2] = (boxes[:, 2] - boxes[:, 0]) / w
    out[:, 3] = (boxes[:, 3] - boxes[:, 1]) / h
    return out


def norm_poly_to_abs(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    if poly.size == 0:
        return poly.astype(np.float32)
    out = poly.astype(np.float32).copy()
    out[:, 0] *= w
    out[:, 1] *= h
    return out


def write_yolo_labels(path: Path, labels: np.ndarray, boxes_norm_cxcywh: np.ndarray,
                      polys_norm=None) -> None:
    """Write predictions back in YOLO format (reference infer.py txt output)."""
    lines = []
    for i in range(len(labels)):
        if polys_norm is not None and polys_norm[i] is not None and len(polys_norm[i]) >= 3:
            coords = " ".join(f"{v:.6f}" for v in np.asarray(polys_norm[i]).reshape(-1))
            lines.append(f"{int(labels[i])} {coords}")
        else:
            b = boxes_norm_cxcywh[i]
            lines.append(f"{int(labels[i])} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f}")
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
