"""HybridEncoder (PyTorch): per-level projection, AIFI self-attention on the
coarsest level, top-down FPN + bottom-up PAN with CSP-ELAN fusion.

Counterpart of custom_d_fine_tpu/models/hybrid_encoder.py; parity target
reference src/d_fine/arch/hybrid_encoder.py (input_proj :345-356, AIFI
:358-372,443-463, sincos embedding :425-441, FPN/PAN :374-408,465-486).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (LN_EPS, BatchNorm, ConvNorm, MultiHeadAttention, RepNCSPELAN4, SCDown,
                     get_activation)


def sincos_pos_embed_2d(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """2D sin-cos positional embedding, [1, h*w, dim] (reference
    hybrid_encoder.py:425-441). The grid is built with indexing='ij' over
    (w, h) and flattened w-major, exactly as the reference does; the order
    differs from the h-major token order only when h != w."""
    assert dim % 4 == 0
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = grid_w.reshape(-1)[:, None] @ omega[None]
    out_h = grid_h.reshape(-1)[:, None] @ omega[None]
    emb = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)
    return emb[None]


class TransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer; the pos embed is added to q and k
    only (reference hybrid_encoder.py:243-290)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.activation = get_activation(activation)

    def forward(self, src: torch.Tensor, pos_embed: torch.Tensor = None) -> torch.Tensor:
        q = src if pos_embed is None else src + pos_embed
        src = self.norm1(src + self.self_attn(q, q, src))
        ff = self.linear2(self.activation(self.linear1(src)))
        return self.norm2(src + ff)


class TransformerEncoder(nn.Module):
    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, src: torch.Tensor, pos_embed: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, pos_embed=pos_embed)
        return src


class HybridEncoder(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 feat_strides: Sequence[int] = (8, 16, 32), hidden_dim: int = 256,
                 nhead: int = 8, dim_feedforward: int = 1024, enc_act: str = "gelu",
                 use_encoder_idx: Sequence[int] = (2,), num_encoder_layers: int = 1,
                 pe_temperature: float = 10000.0, expansion: float = 1.0,
                 depth_mult: float = 1.0, act: str = "silu"):
        super().__init__()
        hd = hidden_dim
        self.hidden_dim = hd
        self.use_encoder_idx = tuple(use_encoder_idx)
        self.pe_temperature = pe_temperature
        self._pe_cache = {}
        n = len(in_channels)
        self.input_proj = nn.ModuleList(
            nn.Sequential(OrderedDict([
                ("conv", nn.Conv2d(c, hd, 1, bias=False)),
                ("norm", BatchNorm(hd)),
            ])) for c in in_channels)
        self.encoder = nn.ModuleList(
            TransformerEncoder([TransformerEncoderLayer(hd, nhead, dim_feedforward, enc_act)
                                for _ in range(num_encoder_layers)])
            for _ in self.use_encoder_idx) if num_encoder_layers > 0 else nn.ModuleList()
        num_blocks = round(3 * depth_mult)
        c4 = round(expansion * hd // 2)
        self.lateral_convs = nn.ModuleList(ConvNorm(hd, hd, 1, 1) for _ in range(n - 1))
        self.fpn_blocks = nn.ModuleList(
            RepNCSPELAN4(hd * 2, hd, hd * 2, c4, num_blocks, act=act) for _ in range(n - 1))
        self.downsample_convs = nn.ModuleList(
            nn.Sequential(SCDown(hd, hd, 3, 2)) for _ in range(n - 1))
        self.pan_blocks = nn.ModuleList(
            RepNCSPELAN4(hd * 2, hd, hd * 2, c4, num_blocks, act=act) for _ in range(n - 1))

    def _pos_embed(self, w: int, h: int, like: torch.Tensor) -> torch.Tensor:
        """The embedding for one (w, h), built once per device and dtype."""
        key = (w, h, like.device, like.dtype)
        if key not in self._pe_cache:
            pe = sincos_pos_embed_2d(w, h, self.hidden_dim, self.pe_temperature)
            self._pe_cache[key] = torch.as_tensor(pe, dtype=like.dtype, device=like.device)
        return self._pe_cache[key]

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """NCHW features in, NCHW PAN outputs out (hidden_dim channels each)."""
        assert len(feats) == len(self.input_proj)
        proj = [p(f) for p, f in zip(self.input_proj, feats)]

        for enc, enc_ind in zip(self.encoder, self.use_encoder_idx):
            B, C, H, W = proj[enc_ind].shape
            src = proj[enc_ind].permute(0, 2, 3, 1).reshape(B, H * W, C)  # h-major tokens
            src = enc(src, self._pos_embed(W, H, src))
            proj[enc_ind] = src.reshape(B, H, W, C).permute(0, 3, 1, 2)

        n = len(proj)
        # top-down FPN (reference :465-476)
        inner_outs = [proj[-1]]
        for idx in range(n - 1, 0, -1):
            k = n - 1 - idx
            feat_high = self.lateral_convs[k](inner_outs[0])
            inner_outs[0] = feat_high
            up = F.interpolate(feat_high, scale_factor=2.0, mode="nearest")
            fused = self.fpn_blocks[k](torch.cat([up, proj[idx - 1]], dim=1))
            inner_outs.insert(0, fused)

        # bottom-up PAN (reference :478-484)
        outs = [inner_outs[0]]
        for idx in range(n - 1):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](torch.cat([down, inner_outs[idx + 1]], dim=1)))
        return outs
