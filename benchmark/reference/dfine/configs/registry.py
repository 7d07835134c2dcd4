"""Typed model registry for D-FINE: every size of the port's registry, n, s,
m, l and x, so that the harness can build, run and check any of them.

A copy of the port's registry, which copies the JAX package's. The values
mirror the original torch repo's size registry (src/d_fine/configs.py:1-213)
and must match the port's (benchmark/tests/test_bench_spec.py). `max_gt` / `dn_max_gt` are the JAX
package's static target capacities, kept so that both registries read alike.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """HGNetv2 backbone selection (reference configs.py:2-6 + per-size blocks)."""

    name: str = "B0"  # B0..B6 arch table
    return_idx: Tuple[int, ...] = (1, 2, 3)
    use_lab: bool = False
    freeze_at: int = 0  # -1 = nothing frozen; >=0 freezes stem (+stages if not stem_only)
    freeze_norm: bool = True
    freeze_stem_only: bool = True
    pretrained: bool = False
    local_model_dir: str = "weight/hgnetv2/"


@dataclass(frozen=True)
class EncoderConfig:
    """HybridEncoder (reference configs.py:7-13 + per-size blocks)."""

    in_channels: Tuple[int, ...] = (512, 1024, 2048)
    feat_strides: Tuple[int, ...] = (8, 16, 32)
    hidden_dim: int = 256
    use_encoder_idx: Tuple[int, ...] = (2,)
    num_encoder_layers: int = 1
    nhead: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.0
    enc_act: str = "gelu"
    act: str = "silu"
    expansion: float = 1.0
    depth_mult: float = 1.0
    pe_temperature: float = 10000.0


@dataclass(frozen=True)
class DecoderConfig:
    """DFINETransformer (reference configs.py:14-24 + per-size blocks)."""

    feat_channels: Tuple[int, ...] = (256, 256, 256)
    feat_strides: Tuple[int, ...] = (8, 16, 32)
    hidden_dim: int = 256
    num_levels: int = 3
    num_layers: int = 6
    num_queries: int = 300
    nhead: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.0
    activation: str = "relu"
    num_points: Tuple[int, ...] = (3, 6, 3)
    reg_max: int = 32
    reg_scale: float = 4.0
    layer_scale: int = 1
    eval_idx: int = -1
    num_denoising: int = 100
    label_noise_ratio: float = 0.5
    box_noise_scale: float = 1.0
    cross_attn_method: str = "default"
    query_select_method: str = "default"
    enable_mask_head: bool = False
    mask_dim: int = 256
    eps: float = 1e-2
    aux_loss: bool = True


@dataclass(frozen=True)
class CriterionConfig:
    """DFINECriterion weights (reference configs.py:25-39)."""

    weight_dict: Dict[str, float] = field(
        default_factory=lambda: {
            "loss_vfl": 1.0,
            "loss_bbox": 5.0,
            "loss_giou": 2.0,
            "loss_fgl": 0.15,
            "loss_ddf": 1.5,
            "loss_mask_bce": 1.0,
            "loss_mask_dice": 1.0,
        }
    )
    losses: Tuple[str, ...] = ("vfl", "boxes", "local")
    alpha: float = 0.75
    gamma: float = 2.0
    reg_max: int = 32
    label_smoothing: float = 0.0


@dataclass(frozen=True)
class MatcherConfig:
    """HungarianMatcher costs (reference configs.py:40-51)."""

    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    cost_mask: float = 1.0
    cost_mask_dice: float = 1.0
    alpha: float = 0.25
    gamma: float = 2.0
    use_focal_loss: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str = "m"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    # --- TPU-specific static-shape knobs (no torch equivalent) ---
    max_gt: int = 100  # padded GT capacity per image (validity-masked)
    dn_max_gt: int = 50  # static per-group GT capacity for denoising layout

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _cfg(
    size: str,
    backbone: BackboneConfig,
    encoder: EncoderConfig,
    decoder: DecoderConfig,
) -> ModelConfig:
    return ModelConfig(name=size, backbone=backbone, encoder=encoder, decoder=decoder)


# Values: reference configs.py:54-200 (sizes_cfg), merged over base_cfg.
MODELS: Dict[str, ModelConfig] = {
    "n": _cfg(
        "n",
        BackboneConfig(name="B0", return_idx=(2, 3), freeze_at=-1, freeze_norm=False, use_lab=True),
        EncoderConfig(
            in_channels=(512, 1024),
            feat_strides=(16, 32),
            hidden_dim=128,
            use_encoder_idx=(1,),
            dim_feedforward=512,
            expansion=0.34,
            depth_mult=0.5,
        ),
        DecoderConfig(
            feat_channels=(128, 128),
            feat_strides=(16, 32),
            hidden_dim=128,
            num_levels=2,
            num_layers=3,
            reg_scale=4.0,
            num_points=(6, 6),
            dim_feedforward=512,
        ),
    ),
    "s": _cfg(
        "s",
        BackboneConfig(name="B0", return_idx=(1, 2, 3), freeze_at=-1, freeze_norm=False, use_lab=True),
        EncoderConfig(
            in_channels=(256, 512, 1024),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            use_encoder_idx=(2,),
            dim_feedforward=1024,
            expansion=0.5,
            depth_mult=0.34,
        ),
        DecoderConfig(
            feat_channels=(256, 256, 256),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            num_levels=3,
            num_layers=3,
            reg_scale=4.0,
            num_points=(3, 6, 3),
        ),
    ),
    "m": _cfg(
        "m",
        BackboneConfig(name="B2", return_idx=(1, 2, 3), freeze_at=-1, freeze_norm=False, use_lab=True),
        EncoderConfig(
            in_channels=(384, 768, 1536),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            use_encoder_idx=(2,),
            dim_feedforward=1024,
            expansion=1.0,
            depth_mult=0.67,
        ),
        DecoderConfig(
            feat_channels=(256, 256, 256),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            dim_feedforward=1024,
            num_levels=3,
            num_layers=4,
            reg_scale=4.0,
            num_points=(3, 6, 3),
        ),
    ),
    "l": _cfg(
        "l",
        BackboneConfig(name="B4", return_idx=(1, 2, 3), freeze_at=0, freeze_norm=True, use_lab=False),
        EncoderConfig(
            in_channels=(512, 1024, 2048),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            use_encoder_idx=(2,),
            dim_feedforward=1024,
            expansion=1.0,
            depth_mult=1.0,
        ),
        DecoderConfig(
            feat_channels=(256, 256, 256),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            dim_feedforward=1024,
            num_levels=3,
            num_layers=6,
            reg_scale=4.0,
            num_points=(3, 6, 3),
        ),
    ),
    "x": _cfg(
        "x",
        BackboneConfig(name="B5", return_idx=(1, 2, 3), freeze_at=0, freeze_norm=True, use_lab=False),
        EncoderConfig(
            in_channels=(512, 1024, 2048),
            feat_strides=(8, 16, 32),
            hidden_dim=384,
            use_encoder_idx=(2,),
            dim_feedforward=2048,
            expansion=1.0,
            depth_mult=1.0,
        ),
        DecoderConfig(
            feat_channels=(384, 384, 384),
            feat_strides=(8, 16, 32),
            hidden_dim=256,
            dim_feedforward=1024,
            num_levels=3,
            num_layers=6,
            reg_scale=8.0,
            num_points=(3, 6, 3),
        ),
    ),
}


def get_model_config(size: str, **overrides) -> ModelConfig:
    cfg = MODELS[size]
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
