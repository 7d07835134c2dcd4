"""The training step (PyTorch): forward with CDN denoising, Hungarian
matching, criterion, backward through the MSDA kernels, clipped 4-group
AdamW and EMA. Counterpart of custom_d_fine_tpu/train/train_step.py
(make_train_step :53-122; reference hot loop src/dl/train.py:505-604).

bf16: the JAX package's dtype=bfloat16 graph becomes torch.autocast(bfloat16)
around the forward, with the MSDA value map in bf16 as its pallas_sep_fast
takes it; the criterion runs in f32, as in both (train.py:569-575). The JAX
package's make_train_multi_step (a lax.scan over K steps) hides its TPU
host's dispatch cost and is not ported.

`build_training` assembles model, criterion, optimizer and state from the
registry, as tools/bench_train.py:36-58 and train/trainer.py:160-190 do. Like
build_serving it runs on the card unless the caller asks for the CPU, and
raises when there is no card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..configs import ModelConfig, get_model_config
from ..deploy.serving import resolve_device
from ..models.denoising import dn_layout, draw_dn_noise
from ..models.dfine import DFINE, build_model
from ..ops.postprocess import topk_detections
from ..parallel.dist import batch_rows
from .criterion import DFINECriterion, with_mask_losses
from .ema import ema_update
from .optim import Optimizer


@dataclass
class TrainState:
    model: DFINE
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]]  # a state_dict: params and BN buffers
    step: int = 0                           # micro-steps taken


def create_train_state(model: DFINE, optimizer: Optimizer, use_ema: bool = True,
                       ema: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
    """The EMA starts as a copy of the model's state, or as `ema`."""
    if use_ema:
        src = model.state_dict() if ema is None else ema
        dev = next(model.parameters()).device
        ema = {k: v.detach().to(dev).clone() for k, v in src.items()}
    return TrainState(model, optimizer, ema if use_ema else None)


def make_train_step(criterion: DFINECriterion, ema_momentum: float = 0.9998,
                    b_accum_steps: int = 1, bf16: bool = False
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], torch.Generator],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch, generator) -> (state, metrics).

    batch = {"images": [B,H,W,3] uint8 (the wire format; /255 here) or
    floating in [0,1] (the model's dtype), "labels": [B,G] int, "boxes": [B,G,4] f32 cxcywh normalised,
    "valid": [B,G] bool, optional "image_valid": [B] bool, and for the mask
    head "masks": [B,G,Hm,Wm] {0,1} at the mask resolution}, on the model's
    device. `generator` (a CPU torch.Generator) draws the denoising noise.
    metrics: total_loss, the pre-clip grad_norm and every loss term (0-d
    tensors on the device; nothing here waits for the card except the
    matcher's one copy of the costs). Under torch.distributed each process
    passes its rows of the global batch and the same `generator` state; the
    loss terms are then this process's shares of the global batch's
    (train/criterion.py), and grad_norm is the global batch's."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        model = state.model.train()
        images = batch["images"]
        if images.dtype == torch.uint8:  # the wire format
            images = images.float() / 255.0
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid", "image_valid", "masks")
                   if k in batch}
        dec = model.decoder
        draws = None
        if dec.num_denoising > 0:  # this process's rows of the global batch's draws
            _, num_dn, _ = dn_layout(dec.num_denoising, dec.dn_max_gt, dec.num_queries)
            start, total = batch_rows(x.shape[0])
            draws = {k: v[start:start + x.shape[0]].to(x.device) for k, v in draw_dn_noise(
                generator, total, num_dn, dec.num_classes).items()}
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            outputs = model(x, targets=targets, dn_draws=draws,
                            msda_value_dtype=torch.bfloat16 if bf16 else None)
        losses = criterion(outputs, targets)
        total = torch.stack(list(losses.values())).sum()
        state.optimizer.zero_grad()
        total.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        if state.ema is not None and state.step % b_accum_steps == 0:
            ema_update(state.ema, model.state_dict(), state.step // b_accum_steps,
                       ema_momentum)
        metrics = {"total_loss": total.detach(), "grad_norm": grad_norm}
        metrics.update({k: v.detach() for k, v in losses.items()})
        return state, metrics

    return train_step


def make_eval_step(use_ema: bool = True, bf16: bool = False
                   ) -> Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]:
    """eval_step(state, images_u8 [B,H,W,3]) -> top-300 detections
    {labels [B,K] int32, boxes [B,K,4] f32 xyxy pixels, scores [B,K] f32,
    and with the mask head masks [B,K,Hm,Wm] f32 probabilities} of the EMA
    weights (the model's own without an EMA), in eval mode, under the
    training's autocast and MSDA value dtype. Counterpart of the JAX
    package's make_eval_step (train_step.py:172) and the Trainer's _eval
    closure (trainer.py:266-277); reference train.py:396-400."""

    @torch.no_grad()
    def eval_step(state: TrainState, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        x = (images_u8.float() / 255.0).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        kw = {"msda_value_dtype": torch.bfloat16 if bf16 else None}
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            if use_ema and state.ema is not None:
                out = torch.func.functional_call(model, state.ema, (x,), kw)
            else:
                out = model(x, **kw)
        return topk_detections(out["pred_logits"].float(), out["pred_boxes"].float(), 300,
                               tuple(images_u8.shape[1:3]), pred_masks=out.get("pred_masks"))

    return eval_step


def build_training(size: Union[str, ModelConfig] = "m", num_classes: int = 80,
                   device: Union[None, str, torch.device] = None, seed: int = 0, *,
                   base_lr: float = 1.5e-4, backbone_lr: float = 2e-5,
                   total_steps: int = 1000, b_accum_steps: int = 1, bf16: bool = True,
                   use_ema: bool = True, ema_momentum: float = 0.9998,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                   ema: Optional[Mapping[str, torch.Tensor]] = None, **optim_kw
                   ) -> Tuple[Callable, TrainState]:
    """Registry size (or a ModelConfig) -> (step_fn, state) on `device`.
    Random weights from `seed` unless `state_dict` (and `ema`) are given, e.g.
    from utils/weights.py. A config with the mask head trains the mask losses
    too, as the Trainer's task "segment" does. bf16=True is the Trainer's
    default compute dtype;
    bf16 on the CPU is refused (the CPU copy is the f32 reference)."""
    device = resolve_device(device)
    if bf16 and device.type != "cuda":
        raise ValueError("bf16 training runs on the card; pass bf16=False on the CPU")
    cfg = get_model_config(size) if isinstance(size, str) else size
    model = build_model(cfg, num_classes=num_classes, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device).to(memory_format=torch.channels_last).train()
    crit_cfg = with_mask_losses(cfg.criterion) if cfg.decoder.enable_mask_head else cfg.criterion
    criterion = DFINECriterion(crit_cfg, cfg.matcher, num_classes=num_classes)
    optimizer = Optimizer(model, cfg, base_lr=base_lr, backbone_lr=backbone_lr,
                          total_steps=total_steps, b_accum_steps=b_accum_steps, **optim_kw)
    state = create_train_state(model, optimizer, use_ema=use_ema, ema=ema)
    step = make_train_step(criterion, ema_momentum=ema_momentum, b_accum_steps=b_accum_steps,
                           bf16=bf16)
    return step, state
