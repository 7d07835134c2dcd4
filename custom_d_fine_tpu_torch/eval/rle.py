"""COCO-style run-length encoding for binary masks (pure numpy).

Replaces the reference's faster_coco_eval RLE codec (src/dl/utils.py:1040-1183)
used for memory-efficient mask transfer between eval shards and the validator.
Column-major (Fortran) order, counts alternate background/foreground starting
with background — the standard COCO uncompressed RLE convention.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def mask_to_rle(mask: np.ndarray) -> Dict:
    """mask [H, W] (0/1) -> {"size": [H, W], "counts": List[int]}."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F")
    # positions where value changes
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:  # must start with a background run
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in rle["counts"]:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def masks_to_rle(masks: np.ndarray) -> List[Dict]:
    return [mask_to_rle(m) for m in masks]


def rle_to_masks(rles: List[Dict]) -> np.ndarray:
    if not rles:
        return np.zeros((0, 1, 1), np.uint8)
    return np.stack([rle_to_mask(r) for r in rles])
