"""Contrastive denoising (CDN) queries with a static layout (PyTorch),
counterpart of custom_d_fine_tpu/models/denoising.py (reference
src/d_fine/arch/utils.py:357-467, get_contrastive_denoising_training_group).

The layout is fixed by the per-image GT capacity `dn_max_gt`, as in the JAX
package: every group of every image has dn_max_gt positive and dn_max_gt
negative slots, filled by cycling the image's valid GTs. The noise model is
the reference's (label flip with p = ratio/2, box jitter of 0-1x the half
size for positives and 1-2x for negatives).

jax.random cannot be reproduced in PyTorch, so the random draws are split
from their use: `draw_dn_noise` makes them from a torch.Generator on the CPU
(a few KB, moved to the device), and `build_cdn_group` takes them as tensors.
A card and a CPU copy then see the same noise, and the tests feed in the
draws that JAX made from the same key.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh, inverse_sigmoid


def dn_layout(num_denoising: int, dn_max_gt: int, num_queries: int):
    """Static layout: (num_group, num_dn_slots, total queries)."""
    num_group = max(1, num_denoising // dn_max_gt)
    num_dn = 2 * num_group * dn_max_gt
    return num_group, num_dn, num_dn + num_queries


def build_dn_attn_mask(num_group: int, dn_max_gt: int, num_queries: int) -> np.ndarray:
    """Block mask (True = blocked): matching queries cannot see DN queries; DN
    groups cannot see each other (reference arch/utils.py:437-455)."""
    pair = 2 * dn_max_gt
    num_dn = num_group * pair
    tgt = num_dn + num_queries
    mask = np.zeros((tgt, tgt), dtype=bool)
    mask[num_dn:, :num_dn] = True
    for g in range(num_group):
        s, e = g * pair, (g + 1) * pair
        mask[s:e, :s] = True
        mask[s:e, e:num_dn] = True
    return mask


def draw_dn_noise(generator: torch.Generator, batch: int, num_dn: int,
                  num_classes: int) -> Dict[str, torch.Tensor]:
    """The random draws of one CDN group build, on the CPU: flip_u U[0,1)
    [B, num_dn] (a label flips where flip_u < ratio/2), new_label
    [B, num_dn] in [0, num_classes), sign [B, num_dn, 4] in {0, 1} (a jitter
    sign of -1 or +1) and part U[0,1) [B, num_dn, 4] (the jitter's size)."""
    g = generator
    return {
        "flip_u": torch.rand((batch, num_dn), generator=g),
        "new_label": torch.randint(0, num_classes, (batch, num_dn), generator=g),
        "sign": torch.randint(0, 2, (batch, num_dn, 4), generator=g),
        "part": torch.rand((batch, num_dn, 4), generator=g),
    }


def build_cdn_group(labels: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                    draws: Dict[str, torch.Tensor], *, num_classes: int, num_group: int,
                    dn_max_gt: int, label_noise_ratio: float,
                    box_noise_scale: float) -> Dict[str, torch.Tensor]:
    """labels [B, G] (padded with num_classes), boxes [B, G, 4] normalised
    cxcywh, valid [B, G] bool, draws from draw_dn_noise -> the DN slots'
    noisy labels and unactivated boxes, and the masks the criterion needs.
    Slot order per group: [dn_max_gt positive | dn_max_gt negative], groups
    concatenated (reference tiling :394-400)."""
    B = labels.shape[0]
    Gd = dn_max_gt
    dev = labels.device
    # cycle-fill the static capacity with the image's valid GTs (slot j holds
    # GT j % n); images without GTs keep fully invalid slots
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)  # valid GTs first
    n = valid.sum(dim=1).clamp(max=Gd)
    slot = torch.arange(Gd, device=dev)[None] % n.clamp(min=1)[:, None]
    gt_index = torch.gather(order, 1, slot)                              # [B, Gd]
    labels = torch.gather(labels, 1, gt_index)
    boxes = torch.gather(boxes, 1, gt_index[..., None].expand(-1, -1, 4))
    valid = (n > 0)[:, None].expand(B, Gd)
    labels = torch.where(valid, labels, torch.full_like(labels, num_classes))
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))

    reps = 2 * num_group
    q_labels = labels.repeat(1, reps)                                    # [B, reps*Gd]
    q_boxes = boxes.repeat(1, reps, 1)
    q_valid = valid.repeat(1, reps)
    neg = torch.cat([torch.zeros(Gd, dtype=torch.bool, device=dev),
                     torch.ones(Gd, dtype=torch.bool, device=dev)]).repeat(num_group)
    neg = neg[None].expand_as(q_labels)

    if label_noise_ratio > 0:
        flip = draws["flip_u"].to(dev) < label_noise_ratio * 0.5
        new_label = draws["new_label"].to(device=dev, dtype=q_labels.dtype)
        q_labels = torch.where(flip & q_valid, new_label, q_labels)

    if box_noise_scale > 0:
        known = box_cxcywh_to_xyxy(q_boxes)
        diff = (q_boxes[..., 2:] * 0.5).repeat(1, 1, 2) * box_noise_scale
        rand_sign = draws["sign"].to(device=dev, dtype=known.dtype) * 2.0 - 1.0
        rand_part = draws["part"].to(device=dev, dtype=known.dtype)
        rand_part = torch.where(neg[..., None], rand_part + 1.0, rand_part)
        known = (known + rand_sign * rand_part * diff).clamp(0.0, 1.0)
        q_boxes = box_xyxy_to_cxcywh(known).abs()

    return {
        "labels": q_labels,                      # [B, num_dn]
        "bbox_unact": inverse_sigmoid(q_boxes),  # [B, num_dn, 4]
        "valid": q_valid,                        # [B, num_dn]
        # positive slot (g, j) is matched to GT gt_index[:, j] by the criterion
        "positive": q_valid & ~neg,              # [B, num_dn]
        "gt_index": gt_index,                    # [B, Gd] slot j -> original GT row
    }
