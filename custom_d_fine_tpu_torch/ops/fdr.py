"""Fine-grained Distribution Refinement (FDR) transforms (PyTorch),
counterpart of custom_d_fine_tpu/ops/fdr.py (reference
src/d_fine/arch/utils.py:119-188 decoding, :267-354 training targets).
translate_gt is branch-free, as in the JAX package."""

from __future__ import annotations

import functools

import torch

from .boxes import box_xyxy_to_cxcywh


def weighting_function(reg_max: int, up: float, reg_scale: float) -> torch.Tensor:
    """Non-uniform bin weighting W(n), length reg_max+1
    (reference arch/utils.py:145-188)."""
    up_t = torch.tensor(abs(up), dtype=torch.float32)
    scale = torch.tensor(abs(reg_scale), dtype=torch.float32)
    upper_bound1 = up_t * scale
    upper_bound2 = up_t * scale * 2.0
    step = (upper_bound1 + 1.0) ** (2.0 / (reg_max - 2))
    left = [-(step ** i) + 1.0 for i in range(reg_max // 2 - 1, 0, -1)]
    right = [step ** i - 1.0 for i in range(1, reg_max // 2)]
    values = [-upper_bound2] + left + [torch.zeros(())] + right + [upper_bound2]
    return torch.stack(values)


@functools.lru_cache(maxsize=8)
def _weighting_on(reg_max: int, up: float, reg_scale: float, device: torch.device):
    """weighting_function on `device`, made once: its copy to the card would
    wait for the host, which a CUDA graph's capture refuses
    (train/graphs.py). Read only."""
    return weighting_function(reg_max, up, reg_scale).to(device)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor, reg_scale: float) -> torch.Tensor:
    """Decode per-edge distances into cxcywh boxes
    (reference arch/utils.py:119-142). points = [cx, cy, w, h]."""
    reg_scale = abs(reg_scale)
    sx = points[..., 2] / reg_scale
    sy = points[..., 3] / reg_scale
    x1 = points[..., 0] - (0.5 * reg_scale + distance[..., 0]) * sx
    y1 = points[..., 1] - (0.5 * reg_scale + distance[..., 1]) * sy
    x2 = points[..., 0] + (0.5 * reg_scale + distance[..., 2]) * sx
    y2 = points[..., 1] + (0.5 * reg_scale + distance[..., 3]) * sy
    return box_xyxy_to_cxcywh(torch.stack([x1, y1, x2, y2], dim=-1))


def translate_gt(gt: torch.Tensor, reg_max: int, reg_scale: float, up: float):
    """Continuous distances -> (left-bin index as float, right weight, left
    weight) (reference arch/utils.py:267-327)."""
    gt = gt.reshape(-1)
    fv = _weighting_on(reg_max, up, reg_scale, gt.device)
    closest_left = (fv[None, :] - gt[:, None] <= 0).sum(dim=1) - 1  # in [-1, reg_max]
    indices = closest_left.float()
    valid = (indices >= 0) & (indices < reg_max)
    safe_idx = closest_left.clamp(0, reg_max - 1)
    left_diffs = (gt - fv[safe_idx]).abs()
    right_diffs = (fv[safe_idx + 1] - gt).abs()
    wr_valid = left_diffs / (left_diffs + right_diffs + 1e-20)
    neg, pos = indices < 0, indices >= reg_max
    zero = torch.zeros_like(wr_valid)
    weight_right = torch.where(pos, 1.0, torch.where(valid, wr_valid, zero))
    weight_left = torch.where(neg, 1.0, torch.where(valid, 1.0 - wr_valid, zero))
    indices = torch.where(neg, 0.0, indices)
    indices = torch.where(pos, reg_max - 0.1, indices)
    return indices, weight_right, weight_left


@torch.no_grad()
def bbox2distance(points: torch.Tensor, bbox: torch.Tensor, reg_max: int, reg_scale: float,
                  up: float, eps: float = 0.1):
    """GT boxes -> FDR bin targets (index, right/left weights) relative to the
    reference points (reference arch/utils.py:330-354). points [N, 4] cxcywh,
    bbox [N, 4] xyxy. No gradient, as in the JAX package."""
    reg_scale = abs(reg_scale)
    sx = points[:, 2] / reg_scale + 1e-16
    sy = points[:, 3] / reg_scale + 1e-16
    left = (points[:, 0] - bbox[:, 0]) / sx - 0.5 * reg_scale
    top = (points[:, 1] - bbox[:, 1]) / sy - 0.5 * reg_scale
    right = (bbox[:, 2] - points[:, 0]) / sx - 0.5 * reg_scale
    bottom = (bbox[:, 3] - points[:, 1]) / sy - 0.5 * reg_scale
    four = torch.stack([left, top, right, bottom], dim=-1)
    idx, wr, wl = translate_gt(four, reg_max, reg_scale, up)
    return idx.clamp(0, reg_max - eps).reshape(-1), wr, wl
