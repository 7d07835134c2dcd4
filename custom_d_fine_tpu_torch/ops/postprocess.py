"""Postprocessing for the serving graph (PyTorch), counterpart of
custom_d_fine_tpu/ops/postprocess.py: sigmoid -> exact flat top-K over Q*C ->
label/query decode -> cxcywh -> absolute xyxy (reference src/dl/export.py:20-100),
and the class-wise NMS of the inference runtime.

The JAX package's fast_topk is a TPU PartialReduce workaround; torch.topk is
exact here."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def box_cxcywh_to_xyxy_scaled(boxes: torch.Tensor, out_w, out_h) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([(cx - 0.5 * w) * out_w, (cy - 0.5 * h) * out_h,
                        (cx + 0.5 * w) * out_w, (cy + 0.5 * h) * out_h], dim=-1)


def topk_detections(
    pred_logits: torch.Tensor,  # [B, Q, C]
    pred_boxes: torch.Tensor,   # [B, Q, 4] normalized cxcywh
    num_top: int = 300,
    out_size: Optional[Tuple[int, int]] = None,  # (H, W) to scale boxes to
    pred_masks: Optional[torch.Tensor] = None,   # [B, Q, Hm, Wm]
) -> Dict[str, torch.Tensor]:
    """Flat top-K over queries x classes (reference export.py:60-99); with
    pred_masks, "masks" [B, K, Hm, Wm] are the masks of the K detections'
    queries (f32)."""
    B, Q, C = pred_logits.shape
    flat = torch.sigmoid(pred_logits.float()).reshape(B, Q * C)
    top_scores, top_idx = torch.topk(flat, min(num_top, Q * C), dim=1)
    labels = (top_idx % C).to(torch.int32)
    q_idx = top_idx // C
    boxes = torch.gather(pred_boxes, 1, q_idx[..., None].expand(-1, -1, 4))
    if out_size is not None:
        H, W = out_size
        boxes = box_cxcywh_to_xyxy_scaled(boxes, W, H)
    out = {"labels": labels, "boxes": boxes, "scores": top_scores}
    if pred_masks is not None:
        out["masks"] = pred_masks[torch.arange(B, device=q_idx.device)[:, None], q_idx].float()
    return out


def classwise_nms_padded(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                         iou_threshold: float = 0.6) -> torch.Tensor:
    """Class-aware greedy NMS over a fixed-size candidate set (boxes [N, 4]
    xyxy, scores [N], labels [N]) -> keep mask [N] bool on the input's device
    (JAX ops/postprocess.py:91-128; reference src/infer/torch_model.py:526-597).

    Same function as the JAX version: a stable descending sort of the scores
    (jnp.argsort is stable, so ties keep input order), the pairwise IoU with
    +1e-9 in the denominator, a pair suppresses when iou > iou_threshold and
    the labels agree, and a greedy pass in sorted order: a candidate is kept
    unless a kept, higher-ranked candidate suppresses it. The N x N pair
    matrix is computed on the input's device; the greedy pass (N steps of
    one row each) runs on the host."""
    order = torch.argsort(-scores, stable=True)
    b, lab = boxes[order].float(), labels[order]
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, None], x2[None, :]) - torch.maximum(x1[:, None], x1[None, :]))
    ih = (torch.minimum(y2[:, None], y2[None, :]) - torch.maximum(y1[:, None], y1[None, :]))
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    iou = inter / (area[:, None] + area[None, :] - inter + 1e-9)
    pair = ((iou > iou_threshold) & (lab[:, None] == lab[None, :])).cpu().numpy()
    n = pair.shape[0]
    keep_sorted = np.ones(n, bool)
    for i in range(n):
        if keep_sorted[i]:  # a kept candidate suppresses the later ones it overlaps
            keep_sorted[i + 1:] &= ~pair[i, i + 1:]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep
