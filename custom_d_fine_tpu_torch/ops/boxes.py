"""Box utilities (PyTorch), counterpart of custom_d_fine_tpu/ops/boxes.py:
conversions, inverse_sigmoid, IoU and GIoU (reference
src/d_fine/arch/utils.py:12-73), safe for padded and degenerate boxes (no
asserts; masked callers decide)."""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = x.unbind(-1)
    w = w.clamp(min=0.0)
    h = h.clamp(min=0.0)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.0):
    """Pairwise IoU: boxes1 [..., N, 4] x boxes2 [..., M, 4] -> ([..., N, M], union)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + eps), union


def _aligned_inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, box_area(boxes1) + box_area(boxes2) - inter


def elementwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                        eps: float = 1e-9) -> torch.Tensor:
    """IoU of aligned pairs: [..., 4] x [..., 4] -> [...]."""
    inter, union = _aligned_inter_union(boxes1, boxes2)
    return inter / (union + eps)


def generalized_box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor,
                                 eps: float = 1e-9) -> torch.Tensor:
    """Pairwise GIoU [..., N, M] (reference arch/utils.py:28-51, minus asserts)."""
    iou, union = box_iou_pairwise(boxes1, boxes2, eps=eps)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / (area + eps)


def elementwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                                    eps: float = 1e-9) -> torch.Tensor:
    """GIoU of aligned pairs [...]."""
    inter, union = _aligned_inter_union(boxes1, boxes2)
    wh_e = (torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
            - torch.minimum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0.0)
    area_e = wh_e[..., 0] * wh_e[..., 1]
    return inter / (union + eps) - (area_e - union) / (area_e + eps)
