"""Serving forward: one place that assembles the deployed graph (PyTorch).

Counterpart of custom_d_fine_tpu/deploy/serving.py. Graph: uint8 NHWC image
-> stem kernel (ops/stem.py, /255 folded into its weights; its fast mode,
bf16 operands with f32 sums, on the card) -> HGNetv2 stages
-> HybridEncoder -> DFINETransformer, whose deformable attention runs
through the MSDA kernel (ops/msda.py) -> exact flat top-K.

Entry points run on the card: device=None means "cuda" and raises when no
GPU is present. With device="cpu" every kernel wrapper takes its plain
version, which is how the tests hold the port against the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..configs import ModelConfig, get_model_config
from ..models.dfine import DFINE, build_model
from ..ops.postprocess import topk_detections
from ..ops.stem import fold_stem_weights, stem_fwd
from .reparam import convert_to_deploy

_AUTO = "auto"


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return device


def build_serving(size: Union[str, ModelConfig] = "m", num_classes: int = 80,
                  img_size: Tuple[int, int] = (640, 640),
                  device: Union[None, str, torch.device] = None, seed: int = 0,
                  state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                  **serving_kw) -> Tuple[Callable, DFINE]:
    """Registry size (or a ModelConfig) -> weights -> deploy reparam ->
    make_serving_forward. The weights are random, drawn from `seed`, unless
    `state_dict` (the port's names, e.g. from utils/weights.flax_to_torch)
    is given. Returns (forward_fn, model)."""
    device = resolve_device(device)
    cfg = get_model_config(size) if isinstance(size, str) else size
    model = build_model(cfg, num_classes=num_classes, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    convert_to_deploy(model)
    model = model.to(device)
    return make_serving_forward(model, tuple(img_size), **serving_kw), model


def make_serving_forward(model: DFINE, img_size: Tuple[int, int], num_top: int = 300,
                         msda_value_dtype: Union[str, None, torch.dtype] = _AUTO,
                         stem_fast: Union[str, bool] = _AUTO
                         ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """(deploy model on its device) -> fn(images_u8 [B,H,W,3]) -> detections
    {labels [B,K] int32, boxes [B,K,4] xyxy pixels, scores [B,K]}.

    H and W must be multiples of 32 (the backbone's stride). msda_value_dtype
    "auto" takes bf16 on the card, as the TPU serving path's pallas_sep_fast
    does, and f32 on the CPU, as the JAX package's "serve" resolves there.
    stem_fast "auto" takes the stem's fast mode (bf16 operands, f32 sums) on
    the card, as the JAX package's serving runs fused_stem(fast=True) on the
    TPU, and the exact f32 stem on the CPU, where the JAX package's serving
    runs the flax StemBlock."""
    H, W = img_size
    if H % 32 or W % 32:
        raise ValueError(f"serving needs H and W divisible by 32, got {H}x{W}")
    device = next(model.parameters()).device
    model.eval().to(memory_format=torch.channels_last)
    if msda_value_dtype == _AUTO:
        msda_value_dtype = torch.bfloat16 if device.type == "cuda" else None
    if stem_fast == _AUTO:
        stem_fast = device.type == "cuda"
    fw = fold_stem_weights(model.backbone.stem)

    @torch.inference_mode()
    def forward(images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        if images_u8.dtype != torch.uint8 or tuple(images_u8.shape[1:]) != (H, W, 3):
            raise ValueError(f"expected uint8 [B,{H},{W},3], got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        stem_out = stem_fwd(images_u8.contiguous(), fw, stem_fast)  # [B, H/4, W/4, O]
        x = stem_out.permute(0, 3, 1, 2)                     # NCHW, channels_last memory
        out = model(x, stem_external=True, msda_value_dtype=msda_value_dtype)
        return topk_detections(out["pred_logits"], out["pred_boxes"], num_top, (H, W))

    return forward
