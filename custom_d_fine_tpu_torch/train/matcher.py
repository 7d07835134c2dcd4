"""Hungarian matching over padded targets (PyTorch), counterpart of
custom_d_fine_tpu/train/matcher.py (reference src/d_fine/matcher.py:110-247).

The costs of every output set (focal class + L1 + GIoU, reference :150-169,
and for the sets that carry masks the focal + Dice mask costs, :175-237)
are computed on the device as one [S, B, Q, G] tensor, copied to the host
once per step and solved there exactly (ops/hungarian.py). Padded GT
columns are masked to a high cost and their assignments dropped.

Under torch.profiler a match records `train.match` with the children
`train.match.costs` (inside it, one `train.match.mask_costs` for each set
with mask costs: counts `sets`, `cells` = B x Q x G x Hm x Wm and `gt_rows`
= B x G, the padded GT rows it runs over), `train.match.copy` (counts
`bytes` device to host, `cells` copied, `valid_cells`: the copied entries
of valid GT columns; in `match_all_sets` also `valid_gt_rows`, the batch's
valid GT rows), `train.match.solve` (`solves`: linear_sum_assignment calls)
and `train.match.upload` (`bytes` host to device); utils/profiling.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..configs.registry import MatcherConfig
from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou_pairwise
from ..ops.hungarian import host_go_union, host_solve
from ..utils.profiling import span


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
    with span("train.match"):
        with span("train.match.copy") as sp:
            n_valid = gt_valid.sum(-1).cpu().numpy()
            c = torch.where(gt_valid[:, None, :], cost.float(), 1e6).cpu().numpy()
            valid_h = gt_valid.cpu().numpy()
            sp.count(bytes=n_valid.nbytes + c.nbytes + valid_h.nbytes, cells=c.size,
                     valid_cells=c.shape[1] * int(n_valid.sum()))
        rounds = []
        with span("train.match.solve", solves=k * int((n_valid > 0).sum())):
            for _ in range(k):
                a = host_solve(c[None], n_valid)[0]                  # [B, G]
                rounds.append(a)
                for b, g in zip(*((a >= 0) & valid_h).nonzero()):
                    c[b, a[b, g]] = 1e6
        with span("train.match.upload") as sp:
            assign = np.stack(rounds)
            sp.count(bytes=assign.nbytes)
            return torch.from_numpy(assign).to(cost.device)


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
            (B, Q, Hm, Wm), G = o["pred_masks"].shape, targets["masks"].shape[1]
            with span("train.match.mask_costs", sets=1, cells=B * Q * G * Hm * Wm, gt_rows=B * G):
                c = c + mask_matching_cost(o["pred_masks"], targets["masks"], cfg)
        return c

    with span("train.match"):
        with span("train.match.costs"):
            valid = targets["valid"]
            costs = torch.where(valid[None, :, None, :],
                                torch.stack([set_cost(o) for o in output_sets]), 1e6)
        with span("train.match.copy") as sp:
            n_valid = valid.sum(-1).cpu().numpy()
            costs = costs.cpu().numpy()
            S, _, Q, _ = costs.shape
            sp.count(bytes=costs.nbytes + n_valid.nbytes, cells=costs.size,
                     valid_cells=S * Q * int(n_valid.sum()), valid_gt_rows=int(n_valid.sum()))
        with span("train.match.solve", solves=S * int((n_valid > 0).sum())):
            assign = host_solve(costs, n_valid)
            go_g, go_valid = host_go_union(assign, n_valid, Q)
        with span("train.match.upload") as sp:
            dev = valid.device
            sp.count(bytes=assign.nbytes + go_g.nbytes + go_valid.nbytes)
            return (torch.from_numpy(assign).to(dev), torch.from_numpy(go_g).to(dev),
                    torch.from_numpy(go_valid).to(dev))
