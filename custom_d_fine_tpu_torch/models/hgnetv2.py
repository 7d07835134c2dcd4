"""HGNetv2 backbone (PyTorch), counterpart of custom_d_fine_tpu/models/hgnetv2.py.

Parity target: reference src/d_fine/arch/hgnetv2.py (StemBlock :115-166,
HG_Block :189-275, HG_Stage :278-329, arch table :344-422, forward :561-568).
The reference's freeze_norm (frozen backbone BatchNorm statistics) is the
BatchNorm `frozen` flag, set by models/dfine.py; freeze_at is a parameter
group of train/optim.py.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBNAct, LightConvBNAct

# stem_channels + per-stage (in, mid, out, num_blocks, downsample, light_block,
# kernel, layer_num): reference hgnetv2.py:344-422. Data table, not code.
ARCH_CONFIGS = {
    "B0": {
        "stem_channels": [3, 16, 16],
        "stages": [
            [16, 16, 64, 1, False, False, 3, 3],
            [64, 32, 256, 1, True, False, 3, 3],
            [256, 64, 512, 2, True, True, 5, 3],
            [512, 128, 1024, 1, True, True, 5, 3],
        ],
    },
    "B1": {
        "stem_channels": [3, 24, 32],
        "stages": [
            [32, 32, 64, 1, False, False, 3, 3],
            [64, 48, 256, 1, True, False, 3, 3],
            [256, 96, 512, 2, True, True, 5, 3],
            [512, 192, 1024, 1, True, True, 5, 3],
        ],
    },
    "B2": {
        "stem_channels": [3, 24, 32],
        "stages": [
            [32, 32, 96, 1, False, False, 3, 4],
            [96, 64, 384, 1, True, False, 3, 4],
            [384, 128, 768, 3, True, True, 5, 4],
            [768, 256, 1536, 1, True, True, 5, 4],
        ],
    },
    "B3": {
        "stem_channels": [3, 24, 32],
        "stages": [
            [32, 32, 128, 1, False, False, 3, 5],
            [128, 64, 512, 1, True, False, 3, 5],
            [512, 128, 1024, 3, True, True, 5, 5],
            [1024, 256, 2048, 1, True, True, 5, 5],
        ],
    },
    "B4": {
        "stem_channels": [3, 32, 48],
        "stages": [
            [48, 48, 128, 1, False, False, 3, 6],
            [128, 96, 512, 1, True, False, 3, 6],
            [512, 192, 1024, 3, True, True, 5, 6],
            [1024, 384, 2048, 1, True, True, 5, 6],
        ],
    },
    "B5": {
        "stem_channels": [3, 32, 64],
        "stages": [
            [64, 64, 128, 1, False, False, 3, 6],
            [128, 128, 512, 2, True, False, 3, 6],
            [512, 256, 1024, 5, True, True, 5, 6],
            [1024, 512, 2048, 2, True, True, 5, 6],
        ],
    },
    "B6": {
        "stem_channels": [3, 48, 96],
        "stages": [
            [96, 96, 192, 2, False, False, 3, 6],
            [192, 192, 512, 3, True, False, 3, 6],
            [512, 384, 1024, 6, True, True, 5, 6],
            [1024, 768, 2048, 3, True, True, 5, 6],
        ],
    },
}


class StemBlock(nn.Module):
    """Stride-4 stem with an asymmetric-pad 2x2 conv branch and a maxpool
    branch (reference hgnetv2.py:115-166): stem1 3x3/s2 -> pad(0,1) ->
    {stem2a 2x2 -> pad(0,1) -> stem2b 2x2 | maxpool 2x2/s1, ceil mode} ->
    concat -> stem3 3x3/s2 -> stem4 1x1. ops/stem.py runs the same function
    as one kernel on the card."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, use_lab: bool = False):
        super().__init__()
        self.stem1 = ConvBNAct(in_chs, mid_chs, 3, stride=2, use_lab=use_lab)
        self.stem2a = ConvBNAct(mid_chs, mid_chs // 2, 2, stride=1, use_lab=use_lab)
        self.stem2b = ConvBNAct(mid_chs // 2, mid_chs, 2, stride=1, use_lab=use_lab)
        self.stem3 = ConvBNAct(mid_chs * 2, mid_chs, 3, stride=2, use_lab=use_lab)
        self.stem4 = ConvBNAct(mid_chs, out_chs, 1, stride=1, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        # the reference's MaxPool2d(2, stride 1, ceil_mode) on the padded map,
        # written as the JAX package writes it (two pairwise maxima), so that a
        # tie (ReLU zeros) splits its gradient as there, not to one element
        xw = torch.maximum(x[..., :-1], x[..., 1:])
        x1 = torch.maximum(xw[..., :-1, :], xw[..., 1:, :])
        x = torch.cat([x1, x2], dim=1)
        return self.stem4(self.stem3(x))


class HGBlock(nn.Module):
    """Dense block: k convs concatenated with the input, then squeeze/excite
    1x1 aggregation, optional residual (reference hgnetv2.py:189-275)."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, layer_num: int,
                 kernel_size: int = 3, residual: bool = False, light_block: bool = False,
                 use_lab: bool = False):
        super().__init__()
        self.residual = residual
        layers = []
        for i in range(layer_num):
            cin = in_chs if i == 0 else mid_chs
            if light_block:
                layers.append(LightConvBNAct(cin, mid_chs, kernel_size, use_lab=use_lab))
            else:
                layers.append(ConvBNAct(cin, mid_chs, kernel_size, use_lab=use_lab))
        self.layers = nn.ModuleList(layers)
        total = in_chs + layer_num * mid_chs
        self.aggregation = nn.Sequential(
            ConvBNAct(total, out_chs // 2, 1, use_lab=use_lab),
            ConvBNAct(out_chs // 2, out_chs, 1, use_lab=use_lab))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        y = x
        for layer in self.layers:
            y = layer(y)
            outs.append(y)
        y = self.aggregation(torch.cat(outs, dim=1))
        return y + x if self.residual else y


class HGStage(nn.Module):
    """Optional depthwise stride-2 downsample + block_num HGBlocks
    (reference hgnetv2.py:278-329)."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, block_num: int,
                 layer_num: int, downsample: bool = True, light_block: bool = False,
                 kernel_size: int = 3, use_lab: bool = False):
        super().__init__()
        self.downsample = (ConvBNAct(in_chs, in_chs, 3, stride=2, groups=in_chs,
                                     use_act=False, use_lab=use_lab)
                           if downsample else nn.Identity())
        self.blocks = nn.Sequential(*[
            HGBlock(in_chs if i == 0 else out_chs, mid_chs, out_chs, layer_num,
                    kernel_size=kernel_size, residual=i != 0,
                    light_block=light_block, use_lab=use_lab)
            for i in range(block_num)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class HGNetv2(nn.Module):
    """Full backbone; returns NCHW features at `return_idx` stages
    (reference hgnetv2.py:332-568)."""

    def __init__(self, arch: str = "B0", return_idx: Sequence[int] = (1, 2, 3),
                 use_lab: bool = False):
        super().__init__()
        cfg = ARCH_CONFIGS[arch]
        stem = cfg["stem_channels"]
        self.return_idx = tuple(return_idx)
        self.stem = StemBlock(stem[0], stem[1], stem[2], use_lab=use_lab)
        self.stages = nn.ModuleList(
            HGStage(in_c, mid_c, out_c, nb, ln, downsample=ds, light_block=light,
                    kernel_size=k, use_lab=use_lab)
            for in_c, mid_c, out_c, nb, ds, light, k, ln in cfg["stages"])

    def forward(self, x: torch.Tensor, stem_external: bool = False) -> List[torch.Tensor]:
        """stem_external=True: `x` is already the stem output (the serving
        path computes it with the stem kernel, ops/stem.py)."""
        if not stem_external:
            x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.return_idx:
                outs.append(x)
        return outs
