"""Mosaic augmentation + random affine (numpy/OpenCV, host-side).

Parity target: reference mosaic geometry (src/dl/utils.py:196-414:
get_mosaic_coordinate, get_transform_matrix, random_affine, box_candidates,
Sutherland-Hodgman polygon clipping) and the dataset mosaic assembly
(src/dl/dataset.py:258-377): 4 images on a 2x canvas around a jittered
center, per-tile rescale, then a random affine (rotate/scale/shear/translate)
down to the target size with degenerate-box filtering.

Provenance note: the geometry here (transform-matrix composition, tile
coordinates, box_candidates thresholds, polygon clipping) is a deliberate
structure-preserving reimplementation of the reference functions above —
this math IS the augmentation-parity contract (training must converge to
within 0.5 mAP of the reference), and the reference code is itself standard
YOLOX-lineage geometry. The surrounding machinery (threaded RNG, mask path,
static-shape padding) is new.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

BORDER = (114, 114, 114)


@dataclass
class MosaicConfig:
    """Mirrors config.yaml train.mosaic_augs (reference config.yaml:85-91)."""

    mosaic_prob: float = 0.8
    no_mosaic_epochs: int = 5
    mosaic_scale: Tuple[float, float] = (0.5, 1.5)
    degrees: float = 0.0
    translate: float = 0.2
    shear: float = 2.0


def mosaic_tile_coords(index: int, xc: int, yc: int, w: int, h: int,
                       target_h: int, target_w: int):
    """Placement of tile `index` around center (xc, yc) on the 2x canvas and
    the matching crop window in the source image (reference utils.py:396-414)."""
    if index == 0:  # top-left
        x1, y1, x2, y2 = max(xc - w, 0), max(yc - h, 0), xc, yc
        sx1, sy1, sx2, sy2 = w - (x2 - x1), h - (y2 - y1), w, h
    elif index == 1:  # top-right
        x1, y1, x2, y2 = xc, max(yc - h, 0), min(xc + w, target_w * 2), yc
        sx1, sy1, sx2, sy2 = 0, h - (y2 - y1), min(w, x2 - x1), h
    elif index == 2:  # bottom-left
        x1, y1, x2, y2 = max(xc - w, 0), yc, xc, min(target_h * 2, yc + h)
        sx1, sy1, sx2, sy2 = w - (x2 - x1), 0, w, min(y2 - y1, h)
    else:  # bottom-right
        x1, y1, x2, y2 = xc, yc, min(xc + w, target_w * 2), min(target_h * 2, yc + h)
        sx1, sy1, sx2, sy2 = 0, 0, min(w, x2 - x1), min(y2 - y1, h)
    return (x1, y1, x2, y2), (sx1, sy1, sx2, sy2)


def clip_polygon_to_rect(poly: np.ndarray, width: float, height: float) -> np.ndarray:
    """Sutherland-Hodgman clip to [0,w]x[0,h] (reference utils.py:219-274)."""
    if poly.size == 0:
        return np.empty((0, 2), np.float32)
    out = poly.astype(np.float64)
    for edge in range(4):
        if len(out) == 0:
            return np.empty((0, 2), np.float32)
        inp = out
        out = []
        for i in range(len(inp)):
            cur, prev = inp[i], inp[i - 1]

            def inside(p):
                if edge == 0:
                    return p[0] >= 0
                if edge == 1:
                    return p[0] <= width
                if edge == 2:
                    return p[1] >= 0
                return p[1] <= height

            def intersect(p1, p2):
                dx, dy = p2[0] - p1[0], p2[1] - p1[1]
                if edge == 0:
                    t = (0 - p1[0]) / dx if dx else 0
                    return np.array([0.0, p1[1] + t * dy])
                if edge == 1:
                    t = (width - p1[0]) / dx if dx else 0
                    return np.array([width, p1[1] + t * dy])
                if edge == 2:
                    t = (0 - p1[1]) / dy if dy else 0
                    return np.array([p1[0] + t * dx, 0.0])
                t = (height - p1[1]) / dy if dy else 0
                return np.array([p1[0] + t * dx, height])

            if inside(cur):
                if not inside(prev):
                    out.append(intersect(prev, cur))
                out.append(cur)
            elif inside(prev):
                out.append(intersect(prev, cur))
        out = np.asarray(out) if len(out) else np.empty((0, 2))
    if len(out) < 3:
        return np.empty((0, 2), np.float32)
    return out.astype(np.float32)


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr=2, ar_thr=20,
                   area_thr=0.1, eps=1e-16) -> np.ndarray:
    """Degenerate-box filter after affine (reference utils.py:286-294).
    box1/box2: [4, N]."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _transform_matrix(img_shape, new_shape, degrees, scale_range, shear, translate,
                      rng: np.random.Generator):
    """T @ S @ R @ C (reference utils.py:297-323)."""
    new_w, new_h = new_shape
    C = np.eye(3)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(scale_range[0], scale_range[1])
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * new_w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * new_h
    return T @ S @ R @ C, s


def random_affine(
    img: np.ndarray,
    targets: np.ndarray,            # [N, 5] = [cls, x1, y1, x2, y2] abs
    segments: Optional[List[np.ndarray]],
    target_size: Tuple[int, int],   # (w, h)
    degrees: float, translate: float, scales, shear: float,
    rng: np.random.Generator,
):
    """Affine warp + box/polygon transform + candidate filter
    (reference utils.py:326-393)."""
    M, scale = _transform_matrix(img.shape[:2], target_size, degrees, scales, shear,
                                 translate, rng)
    if (M != np.eye(3)).any():
        img = cv2.warpAffine(img, M[:2], dsize=target_size, borderValue=BORDER)

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3), np.float32)
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = (xy @ M.T)[:, :2].reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, target_size[0])
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, target_size[1])

        segs_out: List[np.ndarray] = []
        if segments is None or len(segments) == 0:
            segs_out = [np.empty((0, 2), np.float32) for _ in range(n)]
        else:
            for idx, s in enumerate(segments):
                if s.size == 0:
                    segs_out.append(np.empty((0, 2), np.float32))
                    continue
                pts = np.concatenate([s, np.ones((len(s), 1), np.float32)], 1)
                pts = (pts @ M.T)[:, :2]
                clipped = clip_polygon_to_rect(pts, target_size[0], target_size[1])
                if clipped.size >= 6:
                    segs_out.append(clipped)
                    new[idx] = [clipped[:, 0].min(), clipped[:, 1].min(),
                                clipped[:, 0].max(), clipped[:, 1].max()]
                else:
                    segs_out.append(np.empty((0, 2), np.float32))

        keep = box_candidates(box1=targets[:, 1:5].T * scale, box2=new.T, area_thr=0.1)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
        segs_out = [segs_out[k] for k, kept in enumerate(keep) if kept]
    else:
        segs_out = []
    return img, targets, segs_out


def build_mosaic(
    samples: List[Dict],            # 4x {"image", "targets" [N,5] abs, "segments"}
    target_hw: Tuple[int, int],     # (h, w)
    mosaic_cfg: MosaicConfig,
    rng: np.random.Generator,
):
    """4-image mosaic on a 2x canvas + random affine down to target
    (reference dataset.py:258-377)."""
    target_h, target_w = target_hw
    canvas = np.full((target_h * 2, target_w * 2, 3), BORDER[0], np.uint8)
    yc = int(rng.uniform(0.5 * target_h, 1.5 * target_h))
    xc = int(rng.uniform(0.5 * target_w, 1.5 * target_w))

    all_targets = []
    all_segments: List[np.ndarray] = []
    for i, s in enumerate(samples):
        img = s["image"]
        h0, w0 = img.shape[:2]
        scale = min(1.0 * target_h / h0, 1.0 * target_w / w0)
        img = cv2.resize(img, (int(w0 * scale), int(h0 * scale)),
                         interpolation=cv2.INTER_LINEAR)
        h, w = img.shape[:2]
        (x1, y1, x2, y2), (sx1, sy1, sx2, sy2) = mosaic_tile_coords(
            i, xc, yc, w, h, target_h, target_w
        )
        canvas[y1:y2, x1:x2] = img[sy1:sy2, sx1:sx2]
        pad_w, pad_h = x1 - sx1, y1 - sy1

        t = s["targets"].copy()
        if len(t):
            t[:, 1:5:2] = t[:, 1:5:2] * scale + pad_w
            t[:, 2:5:2] = t[:, 2:5:2] * scale + pad_h
            all_targets.append(t)
        segs = s.get("segments")
        if segs:  # keep 1:1 alignment with this sample's targets
            for seg in segs:
                if seg.size:
                    seg = seg * scale + np.array([pad_w, pad_h], np.float32)
                all_segments.append(seg.astype(np.float32))
        else:
            all_segments.extend(np.empty((0, 2), np.float32) for _ in range(len(t)))

    targets = (np.concatenate(all_targets) if all_targets
               else np.zeros((0, 5), np.float32))
    # clip to 2x canvas
    if len(targets):
        targets[:, 1:5:2] = targets[:, 1:5:2].clip(0, 2 * target_w)
        targets[:, 2:5:2] = targets[:, 2:5:2].clip(0, 2 * target_h)

    img, targets, segments = random_affine(
        canvas, targets, all_segments, (target_w, target_h),
        mosaic_cfg.degrees, mosaic_cfg.translate, mosaic_cfg.mosaic_scale,
        mosaic_cfg.shear, rng,
    )
    return img, targets, segments
