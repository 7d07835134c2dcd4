"""Hungarian matching over padded targets (PyTorch), counterpart of
custom_d_fine_tpu/train/matcher.py (reference src/d_fine/matcher.py:110-247).

The costs of every output set (focal class + L1 + GIoU, reference :150-169)
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
def match_all_sets(output_sets: List[Dict[str, torch.Tensor]],
                   targets: Dict[str, torch.Tensor],
                   cfg: MatcherConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Costs of every output set (set 0 must be the final layer), one copy
    to the host, exact solves there. Returns assign [S, B, G] (query per GT, -1
    invalid), go_g [B, Q] and go_valid [B, Q] (the GO-union indices), on the
    targets' device."""
    costs = torch.stack([matching_cost(o["pred_logits"], o["pred_boxes"], targets["labels"],
                                       targets["boxes"], cfg) for o in output_sets])
    valid = targets["valid"]
    costs = torch.where(valid[None, :, None, :], costs, 1e6)
    n_valid = valid.sum(-1).cpu().numpy()
    assign = host_solve(costs.cpu().numpy(), n_valid)
    num_queries = output_sets[0]["pred_logits"].shape[1]
    go_g, go_valid = host_go_union(assign, n_valid, num_queries)
    dev = valid.device
    return (torch.from_numpy(assign).to(dev), torch.from_numpy(go_g).to(dev),
            torch.from_numpy(go_valid).to(dev))
