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
from .criterion import DFINECriterion
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

    batch = {"images": [B,H,W,3] uint8 (the wire format; /255 here) or f32 in
    [0,1], "labels": [B,G] int, "boxes": [B,G,4] f32 cxcywh normalised,
    "valid": [B,G] bool, optional "image_valid": [B] bool}, on the model's
    device. `generator` (a CPU torch.Generator) draws the denoising noise.
    metrics: total_loss, the pre-clip grad_norm and every loss term (0-d
    tensors on the device; nothing here waits for the card except the
    matcher's one copy of the costs)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        model = state.model.train()
        images = batch["images"]
        if images.dtype != torch.float32:  # uint8 wire path
            images = images.float() / 255.0
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid", "image_valid")
                   if k in batch}
        dec = model.decoder
        draws = None
        if dec.num_denoising > 0:
            _, num_dn, _ = dn_layout(dec.num_denoising, dec.dn_max_gt, dec.num_queries)
            draws = {k: v.to(x.device) for k, v in draw_dn_noise(
                generator, x.shape[0], num_dn, dec.num_classes).items()}
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
    from utils/weights.py. bf16=True is the Trainer's default compute dtype;
    bf16 on the CPU is refused (the CPU copy is the f32 reference)."""
    device = resolve_device(device)
    if bf16 and device.type != "cuda":
        raise ValueError("bf16 training runs on the card; pass bf16=False on the CPU")
    cfg = get_model_config(size) if isinstance(size, str) else size
    model = build_model(cfg, num_classes=num_classes, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device).to(memory_format=torch.channels_last).train()
    criterion = DFINECriterion(cfg.criterion, cfg.matcher, num_classes=num_classes)
    optimizer = Optimizer(model, cfg, base_lr=base_lr, backbone_lr=backbone_lr,
                          total_steps=total_steps, b_accum_steps=b_accum_steps, **optim_kw)
    state = create_train_state(model, optimizer, use_ema=use_ema, ema=ema)
    step = make_train_step(criterion, ema_momentum=ema_momentum, b_accum_steps=b_accum_steps,
                           bf16=bf16)
    return step, state
