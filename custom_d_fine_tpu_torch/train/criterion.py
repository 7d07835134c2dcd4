"""D-FINE criterion (PyTorch): VFL (or focal) + box L1/GIoU + FGL/DDF over
padded, masked matches. Counterpart of custom_d_fine_tpu/train/criterion.py
(DFINECriterion :308-487; reference src/d_fine/dfine_criterion.py
loss_labels_vfl :92-122, loss_boxes :124-143, loss_local :145-237, forward
:609-777, GO union :570-591, CDN matches :809-831).

Every output set (final, aux layers, pre, encoder) is matched by one
batched host solve per step (train/matcher.py). Boolean indexing is
replaced by gathers and scatters with validity masks, as in the JAX package,
so shapes stay static and nothing syncs but the matcher's one copy. FGL
targets are computed once per index set and reused across layers (the
reference points are the layer-0 pre boxes for every layer); num_pos_neg of
the final layer's DDF carries to the aux and dn layers, as in JAX. With
"masks" in the losses, the sets that carry pred_masks (final, aux, the dn
sets but the last, and dn_pred_masks as "_dn_final") add the box-cropped BCE
and Dice mask losses (reference loss_masks :504-556).

Every normaliser (num_boxes, the GO and denoising counts, the DDF counts,
each mask set's matched count) is the count of the global batch: under
torch.distributed it is summed over the processes
(parallel/dist.py:global_sum), as the JAX package's sharded sum is global. Each process's losses are then its share of the global batch's, and
the shares add up to them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.registry import CriterionConfig, MatcherConfig
from ..ops.boxes import box_cxcywh_to_xyxy, elementwise_box_iou, elementwise_generalized_box_iou
from ..ops.fdr import bbox2distance
from ..parallel.dist import global_sum
from .matcher import match_all_sets

Match = Dict[str, torch.Tensor]  # {"q": [B,M], "g": [B,M], "valid": [B,M]}


def _gather_q(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x [B, Q, ...] at query indices q [B, M] (clipped) -> [B, M, ...]."""
    qc = q.clamp(0, x.shape[1] - 1)
    idx = qc.reshape(qc.shape + (1,) * (x.ndim - 2)).expand(qc.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _scatter_q(base: torch.Tensor, q: torch.Tensor, vals: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """base [B, Q] with vals [B, M] written at queries q where valid; the
    invalid entries go to a spare column that is dropped."""
    Q = base.shape[1]
    ext = torch.cat([base, base[:, :1]], dim=1)
    return ext.scatter(1, torch.where(valid, q, Q), vals.to(base.dtype))[:, :Q]


def _bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy_with_logits, elementwise."""
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def _matched_ious(pred_boxes, targets, match) -> torch.Tensor:
    src = _gather_q(pred_boxes, match["q"])
    tgt = _gather_q(targets["boxes"], match["g"])
    iou = elementwise_box_iou(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt))
    return iou.detach() * match["valid"]


def _target_classes(outputs, targets, match, num_classes):
    logits = outputs["pred_logits"].float()
    B, Q, C = logits.shape
    labels_m = _gather_q(targets["labels"].long(), match["g"])
    tc = _scatter_q(torch.full((B, Q), num_classes, dtype=torch.long, device=logits.device),
                    match["q"], labels_m, match["valid"])
    return logits, F.one_hot(tc, C + 1)[..., :C].float()  # class C (no object) -> zeros


def _image_valid(loss, targets):
    iv = targets.get("image_valid")
    return loss if iv is None else loss * iv.float()[:, None, None]


def loss_labels_vfl(outputs, targets, match: Match, num_boxes, num_classes: int,
                    alpha: float, gamma: float) -> Dict[str, torch.Tensor]:
    """IoU-weighted varifocal loss (reference :92-122), sum / num_boxes."""
    logits, target = _target_classes(outputs, targets, match, num_classes)
    ious = _matched_ious(outputs["pred_boxes"], targets, match)
    score = _scatter_q(torch.zeros(logits.shape[:2], device=logits.device), match["q"], ious,
                       match["valid"])
    target_score = score[..., None] * target
    pred_score = torch.sigmoid(logits).detach()
    weight = alpha * pred_score ** gamma * (1.0 - target) + target_score
    elem = _image_valid(_bce_logits(logits, target_score) * weight, targets)
    return {"loss_vfl": elem.sum() / num_boxes}


def loss_labels_focal(outputs, targets, match: Match, num_boxes, num_classes: int,
                      alpha: float, gamma: float, label_smoothing: float = 0.0):
    """Sigmoid focal classification loss (reference :68-90)."""
    logits, target = _target_classes(outputs, targets, match, num_classes)
    if label_smoothing > 0:
        target = target * (1 - label_smoothing) + label_smoothing / logits.shape[-1]
    p = torch.sigmoid(logits)
    p_t = p * target + (1 - p) * (1 - target)
    loss = _bce_logits(logits, target) * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * target + (1 - alpha) * (1 - target)) * loss
    return {"loss_focal": _image_valid(loss, targets).sum() / num_boxes}


def loss_boxes(outputs, targets, match: Match, num_boxes) -> Dict[str, torch.Tensor]:
    """L1 + GIoU on matched pairs (reference :124-143)."""
    src = _gather_q(outputs["pred_boxes"].float(), match["q"])
    tgt = _gather_q(targets["boxes"], match["g"])
    v = match["valid"].float()
    l1 = ((src - tgt).abs() * v[..., None]).sum() / num_boxes
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt))
    return {"loss_bbox": l1, "loss_giou": ((1.0 - giou) * v).sum() / num_boxes}


def compute_fgl_targets(outputs, targets, match: Match, reg_max: int):
    """FGL bin targets from the matched reference points and GT boxes
    (reference :156-172 and arch/utils.py:330-354)."""
    ref = _gather_q(outputs["ref_points"].float(), match["q"]).detach()
    tgt = _gather_q(targets["boxes"], match["g"])
    B, M = match["q"].shape
    idx, wr, wl = bbox2distance(ref.reshape(-1, 4), box_cxcywh_to_xyxy(tgt).reshape(-1, 4),
                                reg_max, outputs["reg_scale"], outputs["up"])
    return idx.reshape(B, M, 4), wr.reshape(B, M, 4), wl.reshape(B, M, 4)


def _ce_int(pred_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of integer labels over the last dim."""
    return -torch.gather(F.log_softmax(pred_logits, dim=-1), -1, labels[..., None])[..., 0]


def _ddf_masks(match: Match, targets, Q: int):
    """The DDF loss's positive and negative queries [B, Q] (bool) on `match`
    and its image count: matched queries, the other queries of valid images,
    and the valid images (padded tail-batch images are neither positive nor
    negative)."""
    B = match["q"].shape[0]
    mask = _scatter_q(torch.zeros((B, Q), dtype=torch.bool, device=match["q"].device),
                      match["q"], torch.ones_like(match["valid"]), match["valid"])
    iv = targets.get("image_valid")
    if iv is None:
        return mask, ~mask, torch.tensor(float(B), device=mask.device)
    img = iv.bool()[:, None]
    return mask & img, ~mask & img, iv.float().sum()


def _ddf_counts(match: Match, targets, Q: int) -> torch.Tensor:
    """This process's [n_pos, n_neg, n_img] of the DDF loss on `match`, each
    query counted once per box side as the loss is."""
    pos, neg, n_img = _ddf_masks(match, targets, Q)
    return torch.stack([4 * pos.sum().float(), 4 * neg.sum().float(), n_img])


def loss_local(outputs, targets, match: Match, num_boxes, reg_max: int, fgl_targets=None,
               num_pos_neg=None, is_dn: bool = False, T: float = 5.0, counts=None):
    """FGL + DDF (reference :145-237). Returns (losses, fgl_targets, num_pos_neg).
    `counts`: the global batch's _ddf_counts on `match` (needed for DDF)."""
    losses: Dict[str, torch.Tensor] = {}
    if "pred_corners" not in outputs:
        return losses, fgl_targets, num_pos_neg
    B, Q = outputs["pred_corners"].shape[:2]
    M = match["q"].shape[1]
    K1 = reg_max + 1
    pred_m = _gather_q(outputs["pred_corners"].float(), match["q"]).reshape(B, M, 4, K1)
    if fgl_targets is None:
        fgl_targets = compute_fgl_targets(outputs, targets, match, reg_max)
    t_idx, wr, wl = fgl_targets
    ious = _matched_ious(outputs["pred_boxes"], targets, match)
    w4 = ious[..., None].expand(B, M, 4) * match["valid"][..., None]
    left = t_idx.long()
    ce = _ce_int(pred_m, left) * wl + _ce_int(pred_m, left + 1) * wr
    losses["loss_fgl"] = (ce * w4).sum() / num_boxes

    if outputs.get("teacher_corners") is not None:
        pred = outputs["pred_corners"].float().reshape(B, Q, 4, K1)
        teacher = outputs["teacher_corners"].float().reshape(B, Q, 4, K1).detach()
        wt = torch.sigmoid(outputs["teacher_logits"].float()).max(-1).values
        wt = _scatter_q(wt, match["q"], ious, match["valid"]).detach()
        pos, neg, _ = _ddf_masks(match, targets, Q)
        mask4, neg4 = pos[..., None].expand(B, Q, 4), neg[..., None].expand(B, Q, 4)
        n_pos, n_neg, n_img = counts.unbind()
        n_img = n_img.clamp(min=1.0)
        kl = (F.softmax(teacher / T, -1) * (F.log_softmax(teacher / T, -1)
                                             - F.log_softmax(pred / T, -1))).sum(-1)
        loss_elem = wt[..., None] * (T ** 2) * kl
        if not is_dn or num_pos_neg is None:
            batch_scale = 8.0 / n_img
            pos_neg = (torch.sqrt(n_pos * batch_scale), torch.sqrt(n_neg * batch_scale))
            if not is_dn:
                num_pos_neg = pos_neg
        else:
            pos_neg = num_pos_neg
        num_pos, num_neg = pos_neg
        l_pos = torch.where(mask4, loss_elem, 0.0).sum() / n_pos.clamp(min=1.0)
        l_neg = torch.where(neg4, loss_elem, 0.0).sum() / n_neg.clamp(min=1.0)
        losses["loss_ddf"] = (l_pos * num_pos + l_neg * num_neg) / (num_pos + num_neg + 1e-12)
    return losses, fgl_targets, num_pos_neg


def with_mask_losses(cfg: CriterionConfig) -> CriterionConfig:
    """The criterion of a model with the mask head: "masks" joins the losses,
    as the reference's build_loss adds it for segment (dfine.py:73-84; JAX
    trainer.py:208-211)."""
    if "masks" in cfg.losses:
        return cfg
    return dataclasses.replace(cfg, losses=tuple(cfg.losses) + ("masks",))


def _inside_box_mask(boxes: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[..., M, 4] xyxy in mask pixels -> [..., M, H, W] {0,1} crop mask
    (reference _cropped_bce_loss :353-369)."""
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)[None, :]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    return (((xs >= x1) & (xs < x2)) & ((ys >= y1) & (ys < y2))).float()


def loss_masks(outputs, targets, match: Match, num_masks) -> Dict[str, torch.Tensor]:
    """Box-cropped BCE + Dice on the matched masks, the BCE normalised by box
    area (reference loss_masks :504-556, _cropped_bce_loss :335-386,
    _cropped_dice_loss :404-450; JAX criterion.py:267-302). targets["masks"]
    [B, G, Hm, Wm] are at the prediction's resolution. num_masks: the global
    batch's count of valid matches of `match`, which the JAX package sums
    itself. Only the matched queries are cast to f32 (JAX casts all of
    pred_masks first: the same function, in less memory)."""
    if outputs.get("pred_masks") is None or targets.get("masks") is None:
        return {}
    pm = outputs["pred_masks"]
    Hm, Wm = pm.shape[-2:]
    rows = torch.arange(pm.shape[0], device=pm.device)[:, None]
    pred = pm[rows, match["q"].clamp(0, pm.shape[1] - 1)].float()  # [B, M, Hm, Wm]
    tgt = targets["masks"][rows, match["g"].clamp(0, targets["masks"].shape[1] - 1)].float()
    v = match["valid"].float()

    cx, cy, w, h = _gather_q(targets["boxes"], match["g"]).unbind(-1)  # normalised cxcywh
    x1 = ((cx - w / 2) * Wm).clamp(0, Wm - 1)
    y1 = ((cy - h / 2) * Hm).clamp(0, Hm - 1)
    x2 = ((cx + w / 2) * Wm).clamp(1, Wm)
    y2 = ((cy + h / 2) * Hm).clamp(1, Hm)
    inside = _inside_box_mask(torch.stack([x1, y1, x2, y2], -1), Hm, Wm)
    area = ((x2 - x1) * (y2 - y1)).clamp(min=1.0)

    per_inst_bce = (_bce_logits(pred, tgt) * inside).sum((-2, -1)) / area  # [B, M]
    prob, tgt = torch.sigmoid(pred) * inside, tgt * inside
    inter = (prob * tgt).sum((-2, -1))
    denom = prob.sum((-2, -1)) + tgt.sum((-2, -1)) + 1e-6
    dice = 1.0 - (2.0 * inter + 1e-6) / denom
    return {"loss_mask_bce": (per_inst_bce * v).sum() / num_masks,
            "loss_mask_dice": (dice * v).sum() / num_masks}


class DFINECriterion:
    """Callable on the train-mode model outputs and the padded targets
    {labels [B,G], boxes [B,G,4] cxcywh, valid [B,G], optional image_valid [B]};
    returns the weighted loss terms, NaN scrubbed to 0 (reference :776)."""

    def __init__(self, cfg: CriterionConfig, matcher_cfg: MatcherConfig, num_classes: int):
        self.cfg, self.mcfg, self.num_classes = cfg, matcher_cfg, num_classes

    def _dn_match(self, dn_meta, targets) -> Match:
        """Static CDN matches (reference :809-831): positive slot j of group g
        <-> the GT that slot was cycle-filled with (gt_index[:, j])."""
        positive = dn_meta["positive"]
        B, num_dn = positive.shape
        num_group = dn_meta["num_group"]
        Gd = num_dn // (2 * num_group)
        q_idx = torch.from_numpy(np.concatenate(
            [np.arange(Gd) + g * 2 * Gd for g in range(num_group)])).to(positive.device)
        valid = positive[:, q_idx]
        if "image_valid" in targets:
            valid = valid & targets["image_valid"][:, None]
        return {"q": q_idx[None].expand(B, -1), "g": dn_meta["gt_index"].long().repeat(1, num_group),
                "valid": valid}

    def _terms(self, out, targets, match, match_go, n, n_go, suffix, add, local=None,
               n_mask=None):
        """Add the cfg.losses terms of one output set: vfl and masks on
        `match`, boxes and local on `match_go`. `local` is the state [fgl
        targets, num_pos_neg, is_dn, the global DDF counts] that loss_local
        carries from set to set, or None to skip it; n_mask, the normaliser of
        the mask losses, or None for a set without masks.
        As in the JAX package, "focal" is a function of this module that the
        criterion does not dispatch."""
        cfg, nc = self.cfg, self.num_classes
        for loss in cfg.losses:
            if loss == "vfl":
                add(loss_labels_vfl(out, targets, match, n, nc, cfg.alpha, cfg.gamma), suffix)
            elif loss == "boxes":
                add(loss_boxes(out, targets, match_go, n_go), suffix)
            elif loss == "local" and local is not None:
                fgl, npn, is_dn, counts = local
                ld, fgl, npn_out = loss_local(out, targets, match_go, n_go, cfg.reg_max, fgl,
                                              npn, is_dn=is_dn, counts=counts)
                add(ld, suffix)
                local[:2] = [fgl, npn_out]
            elif loss == "masks" and n_mask is not None:
                add(loss_masks(out, targets, match, n_mask), suffix)

    def __call__(self, outputs: Dict[str, object], targets: Dict[str, torch.Tensor]):
        wd = self.cfg.weight_dict
        losses: Dict[str, torch.Tensor] = {}

        def add(ldict, suffix=""):
            for k, val in ldict.items():
                if k in wd:
                    losses[k + suffix] = val * wd[k]

        # ---- one batched match over every output set (reference :616-633)
        aux_sets = list(outputs.get("aux_outputs", []))
        enc_sets = list(outputs["enc_aux_outputs"])
        sets = [outputs] + aux_sets + [outputs["pre_outputs"]] + enc_sets
        assign, go_g, go_valid = match_all_sets(sets, targets, self.mcfg)
        B, G = targets["labels"].shape
        Q = outputs["pred_logits"].shape[1]
        dev = go_g.device
        g_base = torch.arange(G, device=dev)[None].expand(B, G)

        def to_match(a):
            return {"q": a, "g": g_base, "valid": (a >= 0) & targets["valid"]}

        n_aux = len(aux_sets)
        matches = [to_match(assign[i]) for i in range(1 + n_aux)]  # final, aux
        match_go = {"q": torch.arange(Q, device=dev)[None].expand(B, Q), "g": go_g,
                    "valid": go_valid}
        has_dn = "dn_outputs" in outputs and outputs.get("dn_meta") is not None
        if has_dn:
            match_dn = self._dn_match(outputs["dn_meta"], targets)
            dn_positive = outputs["dn_meta"]["positive"]
            if "image_valid" in targets:
                dn_positive = dn_positive & targets["image_valid"][:, None]
        masks = ("masks" in self.cfg.losses and outputs.get("pred_masks") is not None
                 and targets.get("masks") is not None)

        # every normaliser of the global batch, in one sum over the processes
        # (parallel/dist.py): num_boxes, the GO count, the DDF counts on the GO
        # matches; with CDN the denoising count and its DDF counts; with the
        # mask losses the valid matches of the final and aux sets, and of the
        # dn sets
        counts = {"boxes": targets["valid"].sum().float()[None],
                  "go": go_valid.sum().float()[None], "ddf": _ddf_counts(match_go, targets, Q)}
        if has_dn:
            counts["dn"] = dn_positive.sum().float()[None]
            counts["ddf_dn"] = _ddf_counts(match_dn, targets, dn_positive.shape[1])
        if masks:
            counts["mask"] = torch.stack([m["valid"].sum().float() for m in matches])
            if has_dn:
                counts["mask_dn"] = match_dn["valid"].sum().float()[None]
        total = global_sum(torch.cat(list(counts.values())))
        counts = dict(zip(counts, total.split([len(c) for c in counts.values()])))
        num_boxes, num_boxes_go = torch.cat([counts["boxes"], counts["go"]]).clamp(min=1.0)
        n_mask = counts["mask"].clamp(min=1.0) if masks else [None] * len(matches)
        extra = {"up": outputs["up"], "reg_scale": outputs["reg_scale"]}

        # fgl targets of the GO matches, num_pos_neg, is_dn, DDF counts
        local = [None, None, False, counts["ddf"]]
        self._terms(outputs, targets, matches[0], match_go, num_boxes, num_boxes_go,
                    "", add, local, n_mask[0])
        for i, aux in enumerate(aux_sets):
            self._terms({**aux, **extra}, targets, matches[1 + i], match_go, num_boxes,
                        num_boxes_go, f"_aux_{i}", add, local, n_mask[1 + i])
        self._terms(outputs["pre_outputs"], targets, to_match(assign[1 + n_aux]), match_go,
                    num_boxes, num_boxes_go, "_pre", add)
        for i, enc in enumerate(enc_sets):
            self._terms(enc, targets, to_match(assign[2 + n_aux + i]), match_go, num_boxes,
                        num_boxes_go, f"_enc_{i}", add)

        # ---- denoising (reference :727-773): static matches, own normaliser
        if has_dn:
            n_dn = counts["dn"][0].clamp(min=1.0)
            n_mask_dn = counts["mask_dn"][0].clamp(min=1.0) if masks else None
            local_dn = [None, local[1], True, counts["ddf_dn"]]
            for i, dn_out in enumerate(outputs["dn_outputs"]):
                self._terms({**dn_out, **extra}, targets, match_dn, match_dn, n_dn, n_dn,
                            f"_dn_{i}", add, local_dn, n_mask_dn)
            if masks and outputs.get("dn_pred_masks") is not None:
                add(loss_masks({"pred_masks": outputs["dn_pred_masks"]}, targets, match_dn,
                               n_mask_dn), "_dn_final")
            if "dn_pre_outputs" in outputs:
                self._terms(outputs["dn_pre_outputs"], targets, match_dn, match_dn, n_dn, n_dn,
                            "_dn_pre", add)
        return {k: torch.nan_to_num(v, nan=0.0) for k, v in losses.items()}
