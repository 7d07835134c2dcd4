"""The instance-segmentation head in plain PyTorch, written from the published
code: MaskDecoder (src/d_fine/arch/dfine_decoder.py:316-370) and the
per-query mask logits (:925-1005). The decoder (models/decoder.py) builds
both only with enable_mask_head; their state_dict names are the published
ones (decoder.mask_decoder.*, decoder.mask_head.*)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Departure: the published module takes torch's GroupNorm eps (1e-5); the JAX
# package takes flax's default (1e-6), and so does the reference.
GN_EPS = 1e-6


class GroupNorm(nn.Module):
    """GroupNorm written out: each group's mean and biased variance over its
    channels and pixels, taken in f32 (as autocast runs torch's group_norm),
    then the per-channel affine. Parameters `weight` and `bias`, as torch's."""

    def __init__(self, groups: int, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.float().reshape(x.shape[0], self.groups, -1)
        centred = g - g.mean(-1, keepdim=True)
        var = centred.square().mean(-1, keepdim=True)
        y = (centred / torch.sqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class MaskDecoder(nn.Module):
    """PAN levels (finest first) -> mask features [B, out_ch, 2 H0, 2 W0]:
    each level's 1x1 lateral conv and GroupNorm(32), the coarser ones brought
    to the finest level's size by bilinear interpolation and added to it, a
    3x3 fusion conv with GroupNorm and ReLU, a bilinear 2x upsample, a 3x3
    up_conv with GroupNorm (`bn1`) and ReLU."""

    def __init__(self, in_channels: Sequence[int], out_ch: int = 256, n_groups: int = 32):
        super().__init__()
        self.lateral = nn.ModuleList(nn.Conv2d(c, out_ch, 1, bias=False) for c in in_channels)
        self.bn = nn.ModuleList(GroupNorm(n_groups, out_ch) for _ in in_channels)
        self.fusion_conv = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.fusion_norm = GroupNorm(n_groups, out_ch)
        self.up_conv = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = GroupNorm(n_groups, out_ch)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        levels = [norm(conv(f)) for conv, norm, f in zip(self.lateral, self.bn, feats)]
        size = levels[0].shape[-2:]
        coarse = sum(F.interpolate(t, size=size, mode="bilinear", align_corners=False)
                     for t in levels[1:])
        x = F.relu(self.fusion_norm(self.fusion_conv(levels[0] + coarse)))
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return F.relu(self.bn1(self.up_conv(x)))


def mask_logits(mask_head: nn.Module, mask_dim: int, queries: torch.Tensor,
                mask_feat: torch.Tensor) -> torch.Tensor:
    """One layer's mask logits [B, Q, Hm, Wm]: the 3-layer MLP's embedding of
    each query [B, Q, C] against the mask features [B, mask_dim, Hm, Wm],
    over sqrt(mask_dim) (the published einsum "bqc,bchw->bqhw")."""
    return torch.einsum("bqc,bchw->bqhw", mask_head(queries), mask_feat) / math.sqrt(mask_dim)
