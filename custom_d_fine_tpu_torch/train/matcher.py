"""Hungarian matching over padded targets (PyTorch), counterpart of
custom_d_fine_tpu/train/matcher.py (reference src/d_fine/matcher.py:110-247).

The box costs of every output set (focal class + L1 + GIoU, reference
:150-169) are queued on the device as one [S, B, Q, G] tensor. Then the
batch's valid GT mask comes to the host, and only each image's valid
columns go on: packed on the device into [S, Q * sum(n)] (the layout of
ops/hungarian.py), plus, for the sets that carry masks, the focal + Dice
mask costs against each image's valid GT masks (:175-237), copied to the
host once per step (through page-locked memory from a card) and solved
there exactly.

Under torch.profiler a match records `train.match` with the children
`train.match.costs` (inside it, one `train.match.mask_costs` for each set
with mask costs: counts `sets`, `cells` = Q x Hm x Wm x sum(n) and
`gt_rows` = sum(n), the valid GT rows it runs over), `train.match.copy`
(counts `bytes` device to host: the valid mask and the packed costs,
`cells` copied, `valid_cells`: the copied entries of valid GT columns, all
of them, and `valid_gt_rows` = sum(n)), `train.match.solve` (`solves`:
linear_sum_assignment calls) and `train.match.upload` (`bytes` host to
device); utils/profiling.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


def _mask_cost(pm: torch.Tensor, tm: torch.Tensor, cfg: MatcherConfig) -> torch.Tensor:
    """One image: [Q, Hm, Wm] mask logits, [n, Hm, Wm] {0,1} GT masks ->
    Dice + focal mask costs [Q, n] in f32."""
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
    return cost


@torch.no_grad()
def mask_matching_cost(pred_masks: torch.Tensor, tgt_masks: torch.Tensor,
                       cfg: MatcherConfig) -> torch.Tensor:
    """[B, Q, Hm, Wm] mask logits, [B, G, Hm, Wm] {0,1} GT masks -> pairwise
    Dice + focal mask costs [B, Q, G] in f32 (reference matcher.py:19-71,
    :175-237; JAX train/matcher.py:66-98). One image at a time, as the JAX
    package's lax.map does, to bound the [Q, Hm*Wm] temporaries."""
    return torch.stack([_mask_cost(pm, tm, cfg) for pm, tm in zip(pred_masks, tgt_masks)])


@torch.no_grad()
def packed_mask_cost(pred_masks: torch.Tensor, tgt_masks: torch.Tensor,
                     n_valid: Sequence[int], cfg: MatcherConfig) -> torch.Tensor:
    """mask_matching_cost against each image's first n_b GT masks only, in
    the packed layout of one set (ops/hungarian.py): [Q * sum(n)]."""
    return torch.cat([_mask_cost(pred_masks[b], tgt_masks[b, :n], cfg).flatten()
                      for b, n in enumerate(n_valid) if n] or [pred_masks.new_zeros(0)])


def _host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host. From a card: one non-blocking copy into page-locked
    memory from PyTorch's caching host allocator (a block is handed out
    again only once the copies that used it are done), then a wait on an
    event."""
    if t.device.type != "cuda":
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _pack(costs: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """costs [S, B, Q, G], valid [B, G] -> (the packed costs [S, Q * sum(n)]
    on the costs' device, each image's first n_b columns; the valid mask
    on the host). Reading the mask is the match's wait for the device."""
    valid_h = _host(valid).numpy()
    blocks = [costs[:, b, :, :n].flatten(1) for b, n in enumerate(valid_h.sum(1).tolist()) if n]
    return torch.cat(blocks, 1) if blocks else costs.new_zeros((costs.shape[0], 0)), valid_h


def _copy(packed: torch.Tensor, valid_h: np.ndarray) -> np.ndarray:
    with span("train.match.copy") as sp:
        out = _host(packed).numpy()
        sp.count(bytes=valid_h.nbytes + out.nbytes, cells=out.size, valid_cells=out.size,
                 valid_gt_rows=int(valid_h.sum()))
    return out


def _upload(device: torch.device, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """The host arrays on `device`: to a card through page-locked memory,
    non-blocking, in stream order before whatever reads them."""
    with span("train.match.upload") as sp:
        sp.count(bytes=sum(a.nbytes for a in arrays))
        if device.type != "cuda":
            return tuple(torch.from_numpy(a).to(device) for a in arrays)
        return tuple(torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                     for a in arrays)


@torch.no_grad()
def match_topk(cost: torch.Tensor, gt_valid: torch.Tensor, k: int) -> torch.Tensor:
    """One-to-many assignment (reference get_top_k_matches, matcher.py:259-285):
    k rounds of exact assignment, each masking out (cost 1e6) the queries the
    earlier rounds took, so every GT gets k distinct queries.
    cost [B, Q, G], gt_valid [B, G] -> assign [k, B, G] (-1 for invalid GTs)."""
    Q = cost.shape[1]
    with span("train.match"):
        with span("train.match.costs"):
            packed, valid_h = _pack(cost.float()[None], gt_valid)
        c = _copy(packed, valid_h)
        n_valid = valid_h.sum(1).tolist()
        rounds = []
        with span("train.match.solve", solves=k * sum(n > 0 for n in n_valid)):
            for _ in range(k):
                a = host_solve(c, valid_h)[0]                        # [B, G]
                rounds.append(a)
                start = 0
                for b, n in enumerate(n_valid):
                    c[0, start:start + Q * n].reshape(Q, n)[a[b, :n]] = 1e6
                    start += Q * n
        return _upload(cost.device, np.stack(rounds))[0]


@torch.no_grad()
def match_all_sets(output_sets: List[Dict[str, torch.Tensor]],
                   targets: Dict[str, torch.Tensor],
                   cfg: MatcherConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Costs of every output set (set 0 must be the final layer; the sets with
    "pred_masks" add the mask costs when the targets hold "masks") over each
    image's valid GT columns, one copy to the host, exact solves there.
    Returns assign [S, B, G] (query per GT, -1 invalid), go_g [B, Q] and
    go_valid [B, Q] (the GO-union indices), on the targets' device."""
    masks = targets.get("masks") if cfg.cost_mask > 0 or cfg.cost_mask_dice > 0 else None
    with span("train.match"):
        with span("train.match.costs"):
            costs = torch.stack([matching_cost(o["pred_logits"], o["pred_boxes"],
                                               targets["labels"], targets["boxes"], cfg)
                                 for o in output_sets])
            packed, valid_h = _pack(costs, targets["valid"])
            n_valid = valid_h.sum(1).tolist()
            S, _, Q, _ = costs.shape
            n = sum(n_valid)
            for s, o in enumerate(output_sets):
                if o.get("pred_masks") is None or masks is None:
                    continue
                px = o["pred_masks"].shape[-2] * o["pred_masks"].shape[-1]
                with span("train.match.mask_costs", sets=1, cells=Q * px * n, gt_rows=n):
                    packed[s] += packed_mask_cost(o["pred_masks"], masks, n_valid, cfg)
        packed = _copy(packed, valid_h)
        with span("train.match.solve", solves=S * sum(n > 0 for n in n_valid)):
            assign = host_solve(packed, valid_h)
            go_g, go_valid = host_go_union(assign, n_valid, Q)
        return _upload(targets["valid"].device, assign, go_g, go_valid)
