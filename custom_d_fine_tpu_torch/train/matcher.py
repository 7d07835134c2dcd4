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

from ..configs.registry import MatcherConfig
from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou_pairwise
from ..ops.hungarian import host_go_union, host_solve


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
    """[B, Q, Hm, Wm] mask logits, [B, G, Hm, Wm] {0,1} GT masks -> pairwise
    Dice + focal mask costs [B, Q, G] in f32 (reference matcher.py:19-71,
    :175-237; JAX train/matcher.py:66-98). One image at a time, as the JAX
    package's lax.map does, to bound the [Q, Hm*Wm] temporaries."""
    costs = []
    for pm, tm in zip(pred_masks, tgt_masks):
        p = pm.reshape(pm.shape[0], -1).float()
        t = tm.reshape(tm.shape[0], -1).float()
        prob = torch.sigmoid(p)
        cost = torch.zeros((p.shape[0], t.shape[0]), device=p.device)
        if cfg.cost_mask_dice > 0:
            num = 2.0 * (prob @ t.T)
            den = prob.sum(1, keepdim=True) + t.sum(1)[None, :]
            cost = cost + cfg.cost_mask_dice * (1.0 - (num + 1e-6) / (den + 1e-6))
        if cfg.cost_mask > 0:
            neg = (1 - cfg.alpha) * (prob ** cfg.gamma) * (-torch.log(1 - prob + 1e-8))
            pos = cfg.alpha * ((1 - prob) ** cfg.gamma) * (-torch.log(prob + 1e-8))
            cost = cost + cfg.cost_mask * (pos @ t.T + neg @ (1.0 - t).T) / p.shape[1]
        costs.append(cost)
    return torch.stack(costs)


@torch.no_grad()
def match_topk(cost: torch.Tensor, gt_valid: torch.Tensor, k: int) -> torch.Tensor:
    """One-to-many assignment (reference get_top_k_matches, matcher.py:259-285):
    k rounds of exact assignment, each masking out (cost 1e6) the queries the
    earlier rounds took, so every GT gets k distinct queries.
    cost [B, Q, G], gt_valid [B, G] -> assign [k, B, G] (-1 for invalid GTs)."""
    n_valid = gt_valid.sum(-1).cpu().numpy()
    c = torch.where(gt_valid[:, None, :], cost.float(), 1e6).cpu().numpy()
    rounds = []
    for _ in range(k):
        a = host_solve(c[None], n_valid)[0]                  # [B, G]
        rounds.append(a)
        for b, g in zip(*((a >= 0) & gt_valid.cpu().numpy()).nonzero()):
            c[b, a[b, g]] = 1e6
    return torch.from_numpy(np.stack(rounds)).to(cost.device)


@torch.no_grad()
def match_all_sets(output_sets: List[Dict[str, torch.Tensor]],
                   targets: Dict[str, torch.Tensor],
                   cfg: MatcherConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Costs of every output set (set 0 must be the final layer; the sets with
    "pred_masks" add the mask costs when the targets hold "masks"), one copy
    to the host, exact solves there. Returns assign [S, B, G] (query per GT, -1
    invalid), go_g [B, Q] and go_valid [B, Q] (the GO-union indices), on the
    targets' device."""
    def set_cost(o):
        c = matching_cost(o["pred_logits"], o["pred_boxes"], targets["labels"],
                          targets["boxes"], cfg)
        if (o.get("pred_masks") is not None and targets.get("masks") is not None
                and (cfg.cost_mask > 0 or cfg.cost_mask_dice > 0)):
            c = c + mask_matching_cost(o["pred_masks"], targets["masks"], cfg)
        return c

    costs = torch.stack([set_cost(o) for o in output_sets])
    valid = targets["valid"]
    costs = torch.where(valid[None, :, None, :], costs, 1e6)
    n_valid = valid.sum(-1).cpu().numpy()
    assign = host_solve(costs.cpu().numpy(), n_valid)
    num_queries = output_sets[0]["pred_logits"].shape[1]
    go_g, go_valid = host_go_union(assign, n_valid, num_queries)
    dev = valid.device
    return (torch.from_numpy(assign).to(dev), torch.from_numpy(go_g).to(dev),
            torch.from_numpy(go_valid).to(dev))
