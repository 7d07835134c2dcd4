"""Serving forward: one place that assembles the deployed graph (PyTorch).

Counterpart of custom_d_fine_tpu/deploy/serving.py. Graph: uint8 NHWC image
-> stem kernel (ops/stem.py, /255 folded into its weights; its fast mode,
bf16 operands with f32 sums, on the card) -> HGNetv2 stages
-> HybridEncoder -> DFINETransformer, whose deformable attention runs
through the MSDA kernel (ops/msda.py) -> exact flat top-K. Variants, as the
JAX package's: int8 weights dequantized in the graph, and bf16 compute.
The graph is an nn.Module (ServingModule) that torch.export can trace:
both kernels are custom ops, so the exported artifact launches them.

Entry points run on the card: device=None means "cuda" and raises when no
GPU is present. With device="cpu" every kernel wrapper takes its plain
version, which is how the tests hold the port against the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..configs import ModelConfig, get_model_config
from ..models.dfine import DFINE, build_model
from ..ops.postprocess import topk_detections
from ..ops.stem import WEIGHT_KEYS, fold_stem_weights, stem_fwd
from .quantize import QuantizedWeights, quantizable_names, quantize_params
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


class ServingModule(nn.Module):
    """The serving graph as one module: uint8 [B,H,W,3] -> detections. It is
    what make_serving_forward calls and what deploy/export.py exports: the
    folded stem weights are buffers (f32), and with quantize_int8 the model's
    quantized weights are int8 buffers dequantized in every forward."""

    def __init__(self, model: DFINE, img_size: Tuple[int, int], num_top: int = 300,
                 msda_value_dtype: Union[str, None, torch.dtype] = _AUTO,
                 stem_fast: Union[str, bool] = _AUTO, quantize_int8: bool = False,
                 bf16: bool = False):
        super().__init__()
        H, W = img_size
        if H % 32 or W % 32:
            raise ValueError(f"serving needs H and W divisible by 32, got {H}x{W}")
        device = next(model.parameters()).device
        if msda_value_dtype == _AUTO:
            msda_value_dtype = torch.bfloat16 if device.type == "cuda" else None
        if stem_fast == _AUTO:
            stem_fast = device.type == "cuda"
        self.img_size, self.num_top, self.bf16 = (H, W), num_top, bf16
        self.msda_value_dtype, self.stem_fast = msda_value_dtype, bool(stem_fast)
        fw = fold_stem_weights(model.backbone.stem)  # from the f32 weights, always
        for k in WEIGHT_KEYS:
            self.register_buffer(f"stem_{k}", fw[k])
        self.register_buffer("stem_wtc", fw.get("wtc"))
        model.eval().to(memory_format=torch.channels_last)
        self.qweights = None
        if quantize_int8:
            # the stem runs on its folded f32 weights: its own convs are not
            # part of this graph and stay as they are
            model = copy.deepcopy(model)
            names = [k for k in quantizable_names(model) if not k.startswith("backbone.stem.")]
            qstate, _ = quantize_params(dict(model.named_parameters()), names)
            for k in names:  # the f32 weight leaves the model
                mod, leaf = model.get_submodule(k.rpartition(".")[0]), k.rpartition(".")[2]
                delattr(mod, leaf)
            self.qweights = QuantizedWeights({k: v for k, v in qstate.items() if "@" in k})
        self.model = model

    def forward(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        H, W = self.img_size
        if images_u8.dtype != torch.uint8 or tuple(images_u8.shape[1:]) != (H, W, 3):
            raise ValueError(f"expected uint8 [B,{H},{W},3], got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        fw = {k: getattr(self, f"stem_{k}") for k in (*WEIGHT_KEYS, "wtc")}
        stem_out = stem_fwd(images_u8.contiguous(), fw, self.stem_fast)  # [B, H/4, W/4, O]
        x = stem_out.permute(0, 3, 1, 2)  # NCHW, channels_last memory
        kw = {"stem_external": True, "msda_value_dtype": self.msda_value_dtype}
        # no autocast region at all in f32: torch.export would wrap the whole
        # model in one even when it is disabled
        with (torch.autocast(x.device.type, dtype=torch.bfloat16) if self.bf16
              else contextlib.nullcontext()):
            if self.qweights is None:
                out = self.model(x, **kw)
            else:
                out = torch.func.functional_call(self.model, self.qweights(), (x,), kw)
        return topk_detections(out["pred_logits"], out["pred_boxes"].float(), self.num_top,
                               (H, W), pred_masks=out.get("pred_masks"))


def make_serving_forward(model: DFINE, img_size: Tuple[int, int], num_top: int = 300,
                         msda_value_dtype: Union[str, None, torch.dtype] = _AUTO,
                         stem_fast: Union[str, bool] = _AUTO, quantize_int8: bool = False,
                         bf16: bool = False
                         ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """(deploy model on its device) -> fn(images_u8 [B,H,W,3]) -> detections
    {labels [B,K] int32, boxes [B,K,4] xyxy pixels, scores [B,K]}, and with
    the mask head masks [B,K,H/4,W/4] (probabilities, f32); the ServingModule
    it runs is `fn.module`.

    H and W must be multiples of 32 (the backbone's stride). msda_value_dtype
    "auto" takes bf16 on the card, as the TPU serving path's pallas_sep_fast
    does, and f32 on the CPU, as the JAX package's "serve" resolves there.
    stem_fast "auto" takes the stem's fast mode (bf16 operands, f32 sums) on
    the card, as the JAX package's serving runs fused_stem(fast=True) on the
    TPU, and the exact f32 stem on the CPU, where the JAX package's serving
    runs the flax StemBlock.

    quantize_int8 stores every conv/Linear/in_proj weight outside the stem as
    per-channel int8 (deploy/quantize.py), dequantized in the graph, as the
    JAX package's make_serving_forward(quantize_int8=True); the stem kernel
    keeps its f32 folded weights, as the TPU graph folds them before
    quantizing. A quantized graph works on a copy of `model`. bf16 runs the
    model under torch.autocast(bfloat16), the counterpart of the JAX
    package's build_model(dtype=bfloat16); the stem and the top-K stay f32."""
    module = ServingModule(model, img_size, num_top, msda_value_dtype, stem_fast,
                           quantize_int8, bf16)

    @torch.inference_mode()
    def forward(images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        return module(images_u8)

    forward.module = module
    return forward
