"""MSDA in plain PyTorch: the gather formulation of ops/deform_attn.py in
f32, differentiable by autograd. Stands where the port launches its kernel."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .deform_attn import ms_deform_attn


def msda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
         attn: torch.Tensor, num_points_list: Sequence[int]) -> torch.Tensor:
    """value [B, Len_v, h, c], loc [B, Lq, h, P, 2], attn [B, Lq, h, P] ->
    f32 [B, Lq, h*c]. A value map in a narrower float dtype is widened first."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return ms_deform_attn(value.float(), spatial_shapes, loc.float(), attn.float(),
                          num_points_list)
