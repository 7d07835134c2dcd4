"""Shared conv/norm/attention building blocks (PyTorch, NCHW activations).

Counterpart of custom_d_fine_tpu/models/layers.py. Submodule names follow the
original torch repo's state_dict keys (src/d_fine/arch/hgnetv2.py and
hybrid_encoder.py), so that utils/weights.py is the inverse of the JAX
package's checkpoint map. BatchNorm uses eps 1e-5 and, in train mode, the
JAX package's running-variance rule (see BatchNorm); LayerNorms are built by
their users with LN_EPS = 1e-6 (flax's default).

The JAX package's PointwiseConv, FlatBatchNorm, dot_conv and s2d_conv are TPU
layout workarounds: nn.Conv2d and nn.BatchNorm2d compute the same function.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LN_EPS = 1e-6  # flax nn.LayerNorm's default, which the JAX package uses (torch's is 1e-5)


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None or name == "identity":
        return lambda x: x
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "leaky_relu":
        return F.leaky_relu
    if name == "gelu":
        return F.gelu  # exact erf form, as torch nn.GELU() and the JAX package
    if name == "hardsigmoid":
        return F.hardsigmoid
    raise ValueError(f"unknown activation {name!r}")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode running variance follows flax, as the JAX
    package's BatchNorm does (custom_d_fine_tpu/models/layers.py:111,155-156):
    the running average takes the *biased* batch variance, where
    nn.BatchNorm2d takes the unbiased one (N/(N-1) larger, N values per
    channel). Flax momentum 0.9 is torch momentum 0.1. The batch itself is
    normalised with the biased variance in both. `frozen` (the backbone's
    freeze_norm) keeps the running statistics in train mode too."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)
        self.frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        m = self.momentum
        rv = self.running_var.clone()  # autograd keeps this one; the buffer stays free
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():  # rv took m * var * n/(n-1); the buffer takes m * var
            kept = self.running_var * (1.0 - m)
            self.running_var.copy_((rv - kept) * ((n - 1) / n) + kept)
            self.num_batches_tracked.add_(1)
        return y


class LearnableAffineBlock(nn.Module):
    """Scalar scale*x + bias (reference hgnetv2.py:25-32)."""

    def __init__(self, scale_value: float = 1.0, bias_value: float = 0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([scale_value]))
        self.bias = nn.Parameter(torch.tensor([bias_value]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x + self.bias


class ConvBNAct(nn.Module):
    """conv(no bias) -> BN -> ReLU -> optional LAB (reference hgnetv2.py:35-80).

    padding="same2" is the torch ZeroPad2d([0,1,0,1]) + valid-conv form.
    """

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: str = "", use_act: bool = True,
                 use_lab: bool = False):
        super().__init__()
        self.same2 = padding == "same2"
        p = 0 if self.same2 else (kernel_size - 1) // 2
        self.conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride, padding=p,
                              groups=groups, bias=False)
        self.bn = BatchNorm(out_chs)
        self.use_act = use_act
        self.lab = LearnableAffineBlock() if use_act and use_lab else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same2:
            x = F.pad(x, (0, 1, 0, 1))
        x = self.bn(self.conv(x))
        if self.use_act:
            x = F.relu(x)
            if self.lab is not None:
                x = self.lab(x)
        return x


class LightConvBNAct(nn.Module):
    """1x1 conv (no act) + depthwise kxk conv (act) (reference hgnetv2.py:83-112)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, use_lab: bool = False):
        super().__init__()
        self.conv1 = ConvBNAct(in_chs, out_chs, 1, use_act=False, use_lab=use_lab)
        self.conv2 = ConvBNAct(out_chs, out_chs, kernel_size, groups=out_chs,
                               use_act=True, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class ConvNorm(nn.Module):
    """conv -> BN -> act (reference ConvNormLayer_fuse, hybrid_encoder.py:21-93)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: Optional[int] = None, bias: bool = False,
                 act: Optional[str] = None):
        super().__init__()
        p = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride, padding=p,
                              groups=groups, bias=bias)
        self.norm = BatchNorm(out_chs)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class SCDown(nn.Module):
    """1x1 conv then depthwise stride-2 conv (reference hybrid_encoder.py:96-103)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 2):
        super().__init__()
        self.cv1 = ConvNorm(in_chs, out_chs, 1, 1)
        self.cv2 = ConvNorm(out_chs, out_chs, kernel_size, stride, groups=out_chs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class VGGBlock(nn.Module):
    """RepVGG-style 3x3+1x1 parallel conv (reference hybrid_encoder.py:106-156).

    Two branches (conv1, conv2) until deploy/reparam.py merges them into one
    biased 3x3 `conv`, as the reference's convert_to_deploy does; deploy=True
    builds that single-conv form directly.
    """

    def __init__(self, in_chs: int, out_chs: int, act: Optional[str] = "silu",
                 deploy: bool = False):
        super().__init__()
        if deploy:
            self.conv = nn.Conv2d(in_chs, out_chs, 3, 1, padding=1, bias=True)
        else:
            self.conv1 = ConvNorm(in_chs, out_chs, 3, 1, padding=1)
            self.conv2 = ConvNorm(in_chs, out_chs, 1, 1, padding=0)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            return self.act(self.conv(x))
        return self.act(self.conv1(x) + self.conv2(x))


class CSPLayer(nn.Module):
    """Cross-stage-partial layer of VGGBlocks (reference hybrid_encoder.py:209-239)."""

    def __init__(self, in_chs: int, out_chs: int, num_blocks: int = 3,
                 expansion: float = 1.0, act: str = "silu"):
        super().__init__()
        hidden = int(out_chs * expansion)
        self.conv1 = ConvNorm(in_chs, hidden, 1, 1, act=act)
        self.conv2 = ConvNorm(in_chs, hidden, 1, 1, act=act)
        self.bottlenecks = nn.Sequential(*[
            VGGBlock(hidden, hidden, act=act) for _ in range(num_blocks)])
        self.conv3 = (ConvNorm(hidden, out_chs, 1, 1, act=act)
                      if hidden != out_chs else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(self.bottlenecks(self.conv1(x)) + self.conv2(x))


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN fusion block (reference hybrid_encoder.py:182-206)."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, num_blocks: int = 3,
                 act: str = "silu"):
        super().__init__()
        self.half = c3 // 2
        self.cv1 = ConvNorm(c1, c3, 1, 1, act=act)
        self.cv2 = nn.Sequential(
            CSPLayer(c3 - self.half, c4, num_blocks, act=act),
            ConvNorm(c4, c4, 3, 1, act=act))
        self.cv3 = nn.Sequential(
            CSPLayer(c4, c4, num_blocks, act=act),
            ConvNorm(c4, c4, 3, 1, act=act))
        self.cv4 = ConvNorm(c3 + 2 * c4, c2, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        y1, y2 = y[:, :self.half], y[:, self.half:]
        b2 = self.cv2(y2)
        b3 = self.cv3(b2)
        return self.cv4(torch.cat([y1, y2, b2, b3], dim=1))


class MLP(nn.Module):
    """num_layers-deep MLP with activation on all but the last layer
    (reference dfine_decoder.py:33-46)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, act: str = "relu"):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x


class MultiHeadAttention(nn.Module):
    """Softmax MHA with separate q/k/v inputs and an optional boolean mask
    (True = blocked). Parameters are laid out as torch nn.MultiheadAttention's
    (packed in_proj_weight/in_proj_bias, out_proj)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        E, h = self.embed_dim, self.num_heads
        d = E // h
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        wq, wk, wv = self.in_proj_weight.split(E)
        bq, bk, bv = self.in_proj_bias.split(E)
        qh = F.linear(q, wq, bq).view(B, Lq, h, d)
        kh = F.linear(k, wk, bk).view(B, Lk, h, d)
        vh = F.linear(v, wv, bv).view(B, Lk, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(B, Lq, E)
        return self.out_proj(out)


def bias_init_with_prob(prior_prob: float = 0.01) -> float:
    """Focal-style classification bias init (reference arch/utils.py:76-79)."""
    return float(-math.log((1 - prior_prob) / prior_prob))
