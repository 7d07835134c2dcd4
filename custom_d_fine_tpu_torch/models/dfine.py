"""DFINE model assembly (backbone -> encoder -> decoder) and the torch-parity
initialisation, counterpart of custom_d_fine_tpu/models/dfine.py.

Parity target: reference src/d_fine/dfine.py:19-124 and the _reset_parameters
blocks of dfine_decoder.py (:100-117 offsets grid bias, :258-264 Gate,
:298-305 LQE, :709-731 heads). The port has no JAX on the card, so it draws
its own random weights, from a torch.Generator, with the same distributions
as the JAX package's build_model: the focal prior and the MSDA grid bias are
what make a randomly initialised model produce meaningful detections.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..configs.registry import ModelConfig
from .decoder import DFINETransformer
from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder
from .layers import BatchNorm, MultiHeadAttention, bias_init_with_prob


class DFINE(nn.Module):
    """backbone -> hybrid encoder -> decoder (reference dfine.py:19-41)."""

    def __init__(self, cfg: ModelConfig, num_classes: int = 80):
        super().__init__()
        b, e, d = cfg.backbone, cfg.encoder, cfg.decoder
        self.cfg, self.num_classes = cfg, num_classes
        self.backbone = HGNetv2(arch=b.name, return_idx=b.return_idx, use_lab=b.use_lab)
        self.encoder = HybridEncoder(
            in_channels=e.in_channels, feat_strides=e.feat_strides, hidden_dim=e.hidden_dim,
            nhead=e.nhead, dim_feedforward=e.dim_feedforward, enc_act=e.enc_act,
            use_encoder_idx=e.use_encoder_idx, num_encoder_layers=e.num_encoder_layers,
            pe_temperature=e.pe_temperature, expansion=e.expansion, depth_mult=e.depth_mult,
            act=e.act)
        self.decoder = DFINETransformer(
            num_classes=num_classes, hidden_dim=d.hidden_dim, num_queries=d.num_queries,
            feat_channels=d.feat_channels, feat_strides=d.feat_strides,
            num_levels=d.num_levels, num_points=d.num_points, nhead=d.nhead,
            num_layers=d.num_layers, dim_feedforward=d.dim_feedforward,
            activation=d.activation, num_denoising=d.num_denoising, dn_max_gt=cfg.dn_max_gt,
            label_noise_ratio=d.label_noise_ratio, box_noise_scale=d.box_noise_scale,
            eval_idx=d.eval_idx, eps=d.eps, reg_max=d.reg_max, reg_scale=d.reg_scale,
            cross_attn_method=d.cross_attn_method,
            query_select_method=d.query_select_method,
            enable_mask_head=d.enable_mask_head, mask_dim=d.mask_dim)

        if b.freeze_norm:  # reference FrozenBatchNorm2d in the backbone
            for m in self.backbone.modules():
                if isinstance(m, BatchNorm):
                    m.frozen = True

    def forward(self, x: torch.Tensor, targets: Optional[Dict[str, torch.Tensor]] = None,
                dn_draws: Optional[Dict[str, torch.Tensor]] = None,
                stem_external: bool = False,
                msda_value_dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
        """x: NCHW f32 image in [0,1], or the stem output when stem_external.
        In train mode, targets {labels, boxes, valid} and dn_draws add the
        denoising queries and the decoder returns every output set the
        criterion reads (models/decoder.py)."""
        feats = self.encoder(self.backbone(x, stem_external=stem_external))
        return self.decoder(feats, msda_value_dtype=msda_value_dtype, targets=targets,
                            dn_draws=dn_draws)


def _msda_offset_bias(num_heads: int, num_points: Sequence[int]) -> np.ndarray:
    """Grid-shaped sampling-offset bias (reference dfine_decoder.py:100-113)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    P = sum(num_points)
    grid = np.tile(grid.reshape(num_heads, 1, 2), (1, P, 1))
    scaling = np.concatenate([np.arange(1, n + 1, dtype=np.float32) for n in num_points])
    return (grid * scaling.reshape(1, -1, 1)).reshape(-1)


@torch.no_grad()
def apply_torch_default_init(model: DFINE, generator: torch.Generator) -> DFINE:
    """Draw every conv/linear weight and bias with the torch reference's
    distributions, as the JAX package's apply_torch_default_init (:96) does:
    U(+-1/sqrt(fan_in)) for weights and biases, xavier_uniform for the decoder
    FFNs, enc_output.proj, query_pos_head layers 0-1 and the 1x1 input_proj
    convs, xavier_uniform on the packed MHA in_proj with zero in_proj and
    out_proj biases, kaiming_normal (fan_out) for the MaskDecoder's up_conv.
    Norms keep (1, 0); the heads' special values come from
    apply_reference_init."""

    def uniform_(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)

    def fan_in(w):
        return w.shape[1] * int(np.prod(w.shape[2:])) if w.ndim == 4 else w.shape[1]

    def fan_out(w):
        return w.shape[0] * int(np.prod(w.shape[2:]))

    def xavier_(w):
        uniform_(w, math.sqrt(6.0 / (fan_in(w) + fan_out(w))))

    up_conv = model.decoder.mask_decoder.up_conv if model.decoder.enable_mask_head else None
    xavier = set()
    for layer in model.decoder.decoder.layers:
        xavier |= {id(layer.linear1), id(layer.linear2)}
    xavier |= {id(model.decoder.enc_output.proj), id(model.decoder.query_pos_head.layers[0]),
               id(model.decoder.query_pos_head.layers[1])}
    for proj in list(model.encoder.input_proj) + list(model.decoder.input_proj):
        if isinstance(proj, nn.Sequential) and proj.conv.kernel_size == (1, 1):
            xavier.add(id(proj.conv))

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            uniform_(m.in_proj_weight, math.sqrt(6.0 / (4.0 * m.embed_dim)))
            m.in_proj_bias.zero_()
        elif m is up_conv:  # reference dfine_decoder.py:351
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_out(m.weight)))
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            if id(m) in xavier:
                xavier_(m.weight)
            else:
                uniform_(m.weight, 1.0 / math.sqrt(fan_in(m.weight)))
            if m.bias is not None:
                uniform_(m.bias, 1.0 / math.sqrt(fan_in(m.weight)))
    for m in model.modules():  # torch MHA zeroes the out_proj bias
        if isinstance(m, MultiHeadAttention):
            m.out_proj.bias.zero_()
    return model


@torch.no_grad()
def apply_reference_init(model: DFINE, generator: torch.Generator) -> DFINE:
    """The reference's special initialisations (JAX apply_reference_init, :171)."""
    dec = model.decoder
    cls_bias = bias_init_with_prob(0.01)
    dec.enc_score_head.bias.fill_(cls_bias)
    for head in dec.dec_score_head:
        head.bias.fill_(cls_bias)
    for mlp in [dec.enc_bbox_head, dec.pre_bbox_head, *dec.dec_bbox_head]:
        mlp.layers[2].weight.zero_()
        mlp.layers[2].bias.zero_()
    d = model.cfg.decoder
    grid = torch.from_numpy(_msda_offset_bias(d.nhead, d.num_points))
    for layer in dec.decoder.layers:
        layer.gateway.gate.weight.zero_()
        layer.gateway.gate.bias.fill_(bias_init_with_prob(0.5))
        layer.cross_attn.sampling_offsets.weight.zero_()
        layer.cross_attn.sampling_offsets.bias.copy_(grid)
        layer.cross_attn.attention_weights.weight.zero_()
        layer.cross_attn.attention_weights.bias.zero_()
    for lqe in dec.decoder.lqe_layers:
        lqe.reg_conf.layers[1].weight.zero_()
        lqe.reg_conf.layers[1].bias.zero_()
    if hasattr(dec, "denoising_class_embed"):
        emb = dec.denoising_class_embed.weight
        emb.copy_(torch.randn(emb.shape, generator=generator))
        emb[-1].zero_()
    return model


def build_model(cfg: ModelConfig, num_classes: int, seed: int = 0) -> DFINE:
    """Construct the model on the CPU with random weights drawn from `seed`,
    in eval mode (reference dfine.py:51-70). Move it with .to(device)."""
    g = torch.Generator().manual_seed(seed)
    model = DFINE(cfg, num_classes=num_classes)
    apply_torch_default_init(model, g)
    apply_reference_init(model, g)
    return model.eval()
