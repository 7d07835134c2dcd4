"""Photometric + geometric augmentations (numpy/OpenCV, host-side).

Replaces the reference's albumentations stack (src/dl/dataset.py:110-185) with
an equivalent op set and probabilities: CoarseDropout, brightness/contrast,
gamma, blur, Gaussian noise, ToGray, 90-degree rotate (fit_output), H/V flip,
+-N-degree rotate with constant (114,114,114) border. Boxes are abs-xyxy and
are transformed exactly (corner transform -> AABB); masks follow the image.

Each op mutates a sample dict {"image" uint8 HWC, "boxes" [N,4] f32 abs-xyxy,
"labels" [N], "masks" optional [N,H,W] uint8} and draws randomness from a
numpy Generator so the pipeline is seedable per-worker (reference
dl/utils.py:38-41 seed_worker semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import cv2
import numpy as np

BORDER = (114, 114, 114)


@dataclass
class AugConfig:
    """Mirrors config.yaml train.augs (reference config.yaml:93-105)."""

    rotation_degree: float = 10.0
    rotation_p: float = 0.05
    multiscale_prob: float = 0.0
    multiscale_deltas: tuple = (-64, -32, 32, 64)  # batch canvas +- px
    rotate_90: float = 0.05
    left_right_flip: float = 0.3
    up_down_flip: float = 0.0
    to_gray: float = 0.01
    blur: float = 0.01
    gamma: float = 0.02
    brightness: float = 0.02
    noise: float = 0.01
    coarse_dropout: float = 0.0


def _transform_boxes_affine(boxes: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Transform abs-xyxy boxes by a 2x3 affine matrix via 4 corners -> AABB."""
    if len(boxes) == 0:
        return boxes
    n = len(boxes)
    corners = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
    pts = np.concatenate([corners, np.ones((n * 4, 1), np.float32)], axis=1)
    out = (pts @ M.T).reshape(n, 4, 2)
    x1 = out[..., 0].min(1)
    y1 = out[..., 1].min(1)
    x2 = out[..., 0].max(1)
    y2 = out[..., 1].max(1)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def _clip_boxes(sample: Dict, w: int, h: int) -> None:
    b = sample["boxes"]
    if len(b) == 0:
        return
    b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, h)


def coarse_dropout(sample, rng) -> None:
    img = sample["image"]
    h, w = img.shape[:2]
    for _ in range(int(rng.integers(1, 3))):
        hh = int(rng.uniform(0.05, 0.15) * h)
        ww = int(rng.uniform(0.05, 0.15) * w)
        y = int(rng.integers(0, max(h - hh, 1)))
        x = int(rng.integers(0, max(w - ww, 1)))
        img[y:y + hh, x:x + ww] = 0


def brightness_contrast(sample, rng) -> None:
    alpha = 1.0 + rng.uniform(-0.2, 0.2)  # contrast
    beta = rng.uniform(-0.2, 0.2) * 255   # brightness
    img = sample["image"].astype(np.float32) * alpha + beta
    sample["image"] = np.clip(img, 0, 255).astype(np.uint8)


def random_gamma(sample, rng) -> None:
    gamma = rng.uniform(0.8, 1.2)
    lut = np.clip(((np.arange(256) / 255.0) ** gamma) * 255.0, 0, 255).astype(np.uint8)
    sample["image"] = lut[sample["image"]]


def blur(sample, rng) -> None:
    k = int(rng.choice([3, 5, 7]))
    sample["image"] = cv2.blur(sample["image"], (k, k))


def gauss_noise(sample, rng) -> None:
    std = rng.uniform(0.1, 0.2) * 255
    noise = rng.normal(0, std, sample["image"].shape).astype(np.float32)
    sample["image"] = np.clip(sample["image"].astype(np.float32) + noise, 0, 255).astype(np.uint8)


def to_gray(sample, rng) -> None:
    g = cv2.cvtColor(sample["image"], cv2.COLOR_RGB2GRAY)
    sample["image"] = np.stack([g, g, g], axis=-1)


def hflip(sample, rng) -> None:
    img = sample["image"]
    w = img.shape[1]
    sample["image"] = img[:, ::-1].copy()
    b = sample["boxes"]
    if len(b):
        sample["boxes"] = np.stack([w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], 1)
    if sample.get("masks") is not None and len(sample["masks"]):
        sample["masks"] = sample["masks"][:, :, ::-1].copy()


def vflip(sample, rng) -> None:
    img = sample["image"]
    h = img.shape[0]
    sample["image"] = img[::-1].copy()
    b = sample["boxes"]
    if len(b):
        sample["boxes"] = np.stack([b[:, 0], h - b[:, 3], b[:, 2], h - b[:, 1]], 1)
    if sample.get("masks") is not None and len(sample["masks"]):
        sample["masks"] = sample["masks"][:, ::-1].copy()


def rotate90(sample, rng) -> None:
    """90-degree CCW rotation with fit_output (image dims swap)."""
    img = sample["image"]
    h, w = img.shape[:2]
    sample["image"] = np.ascontiguousarray(np.rot90(img))
    b = sample["boxes"]
    if len(b):
        # (x, y) -> (y, w - x); boxes re-AABBed
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        sample["boxes"] = np.stack([y1, w - x2, y2, w - x1], 1).astype(np.float32)
    if sample.get("masks") is not None and len(sample["masks"]):
        sample["masks"] = np.ascontiguousarray(np.rot90(sample["masks"], axes=(1, 2)))


def rotate(sample, rng, max_deg: float = 10.0) -> None:
    img = sample["image"]
    h, w = img.shape[:2]
    ang = rng.uniform(-max_deg, max_deg)
    M = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
    sample["image"] = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                                     borderMode=cv2.BORDER_CONSTANT, borderValue=BORDER)
    sample["boxes"] = _transform_boxes_affine(sample["boxes"], M)
    _clip_boxes(sample, w, h)
    if sample.get("masks") is not None and len(sample["masks"]):
        sample["masks"] = np.stack([
            cv2.warpAffine(m, M, (w, h), flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            for m in sample["masks"]
        ])


def apply_train_augs(sample: Dict, cfg: AugConfig, rng: np.random.Generator) -> Dict:
    """Order matches the reference pipeline (dataset.py:134-161)."""
    if rng.random() < cfg.coarse_dropout:
        coarse_dropout(sample, rng)
    if rng.random() < cfg.brightness:
        brightness_contrast(sample, rng)
    if rng.random() < cfg.gamma:
        random_gamma(sample, rng)
    if rng.random() < cfg.blur:
        blur(sample, rng)
    if rng.random() < cfg.noise:
        gauss_noise(sample, rng)
    if rng.random() < cfg.to_gray:
        to_gray(sample, rng)
    if rng.random() < cfg.rotate_90:
        rotate90(sample, rng)
    if rng.random() < cfg.left_right_flip:
        hflip(sample, rng)
    if rng.random() < cfg.up_down_flip:
        vflip(sample, rng)
    if rng.random() < cfg.rotation_p:
        rotate(sample, rng, cfg.rotation_degree)
    return sample
