"""Hungarian matching over padded targets (PyTorch), counterpart of
custom_d_fine_tpu/train/matcher.py (reference src/d_fine/matcher.py:110-247).

The costs of every output set (focal class + L1 + GIoU, reference :150-169,
and for the sets that carry masks the focal + Dice mask costs, :175-237)
are computed on the device as one [S, B, Q, G] tensor, copied to the host
once per step and solved there exactly (ops/hungarian.py). Padded GT
columns are masked to a high cost and their assignments dropped.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.registry import MatcherConfig
from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou_pairwise
from ..ops.hungarian import host_go_union, host_solve

DICE_EPS = 1e-6  # the Dice cost's smoothing, the JAX package's value


@torch.no_grad()
def matching_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                  cfg: MatcherConfig) -> torch.Tensor:
    """[B, Q, C] logits, [B, Q, 4] cxcywh, [B, G] labels, [B, G, 4] cxcywh ->
    cost [B, Q, G] in f32 (reference matcher.py:131-169)."""
    logits, pb, tb = pred_logits.float(), pred_boxes.float(), tgt_boxes.float()
    Q = logits.shape[1]
    lbl = tgt_labels.long().clamp(0, logits.shape[-1] - 1)[:, None, :].expand(-1, Q, -1)
    if cfg.use_focal_loss:
        p = torch.gather(torch.sigmoid(logits), 2, lbl)
        neg_cost = (1 - cfg.alpha) * (p ** cfg.gamma) * (-torch.log(1 - p + 1e-8))
        pos_cost = cfg.alpha * ((1 - p) ** cfg.gamma) * (-torch.log(p + 1e-8))
        cost_class = pos_cost - neg_cost
    else:
        cost_class = -torch.gather(torch.softmax(logits, -1), 2, lbl)
    cost_bbox = (pb[:, :, None, :] - tb[:, None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou_pairwise(box_cxcywh_to_xyxy(pb), box_cxcywh_to_xyxy(tb))
    C = cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class + cfg.cost_giou * cost_giou
    return torch.nan_to_num(C, nan=1.0)


@torch.no_grad()
def mask_matching_cost(pred_masks: torch.Tensor, tgt_masks: torch.Tensor,
                       cfg: MatcherConfig) -> torch.Tensor:
    """[B, Q, Hm, Wm] mask logits, [B, G, Hm', Wm'] {0,1} GT masks -> the
    pairwise mask costs [B, Q, G] in f32, one image at a time as the
    published matcher loops its images (:175-237): cost_mask_dice times the
    Dice cost (dice_cost :19-39) plus cost_mask times the focal cost
    (sigmoid_focal_cost :42-71), the latter a mean over the pixels. The GT
    masks are brought to the prediction's size first (the identity where
    the generator makes them at that size)."""
    out = []
    for logits, gt in zip(pred_masks, tgt_masks):
        gt = F.interpolate(gt[None].float(), size=logits.shape[-2:], mode="nearest")[0]
        x, t = logits.flatten(1).float(), gt.flatten(1)          # [Q, P], [G, P]
        p = torch.sigmoid(x)
        inter = torch.einsum("qp,gp->qg", p, t)
        dice = 1.0 - (2.0 * inter + DICE_EPS) / (p.sum(1)[:, None] + t.sum(1)[None, :] + DICE_EPS)
        # -log p = softplus(-x) and -log(1 - p) = softplus(x); the JAX package
        # adds 1e-8 inside its logs, which moves no cost by 1e-7 at |x| < 9
        pos = cfg.alpha * (1.0 - p) ** cfg.gamma * F.softplus(-x)
        neg = (1.0 - cfg.alpha) * p ** cfg.gamma * F.softplus(x)
        focal = (torch.einsum("qp,gp->qg", pos, t)
                 + torch.einsum("qp,gp->qg", neg, 1.0 - t)) / x.shape[1]
        out.append(cfg.cost_mask_dice * dice + cfg.cost_mask * focal)
    return torch.stack(out)


@torch.no_grad()
def match_all_sets(output_sets: List[Dict[str, torch.Tensor]],
                   targets: Dict[str, torch.Tensor],
                   cfg: MatcherConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Costs of every output set (set 0 must be the final layer; the sets with
    "pred_masks" add the mask costs when the targets hold "masks"), one copy
    to the host, exact solves there. Returns assign [S, B, G] (query per GT, -1
    invalid), go_g [B, Q] and go_valid [B, Q] (the GO-union indices), on the
    targets' device."""
    costs = torch.stack([matching_cost(o["pred_logits"], o["pred_boxes"], targets["labels"],
                                       targets["boxes"], cfg) for o in output_sets])
    if targets.get("masks") is not None:
        costs = torch.stack([c + mask_matching_cost(o["pred_masks"], targets["masks"], cfg)
                             if "pred_masks" in o else c for c, o in zip(costs, output_sets)])
    valid = targets["valid"]
    costs = torch.where(valid[None, :, None, :], costs, 1e6)
    n_valid = valid.sum(-1).cpu().numpy()
    assign = host_solve(costs.cpu().numpy(), n_valid)
    num_queries = output_sets[0]["pred_logits"].shape[1]
    go_g, go_valid = host_go_union(assign, n_valid, num_queries)
    dev = valid.device
    return (torch.from_numpy(assign).to(dev), torch.from_numpy(go_g).to(dev),
            torch.from_numpy(go_valid).to(dev))
