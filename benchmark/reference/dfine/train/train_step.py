"""One training step in plain PyTorch: forward with CDN denoising, matching,
criterion, backward by autograd through the plain MSDA, clipped 4-group AdamW
and EMA, in f32. The same sequence of operations and random draws as the
port's `train/train_step.py`, so that from the same weights, batch and
denoising generator both take the same step up to rounding."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models.denoising import dn_layout, draw_dn_noise
from ..models.dfine import DFINE
from .criterion import DFINECriterion
from .ema import ema_update
from .optim import Optimizer


@dataclass
class RefState:
    model: DFINE
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]]
    step: int = 0


def train_step(state: RefState, criterion: DFINECriterion, batch: Dict[str, torch.Tensor],
               generator: torch.Generator, ema_momentum: float = 0.9998) -> Dict[str, torch.Tensor]:
    """batch as the port's step takes it (uint8 images [B, H, W, 3], labels,
    boxes cxcywh, valid, and for the mask head masks [B, G, Hm, Wm] {0,1});
    returns {total_loss, grad_norm, every loss term}."""
    model = state.model.train()
    x = (batch["images"].float() / 255.0).permute(0, 3, 1, 2).contiguous()
    targets = {k: batch[k] for k in ("labels", "boxes", "valid", "image_valid", "masks")
               if k in batch}
    dec = model.decoder
    draws = None
    if dec.num_denoising > 0:
        _, num_dn, _ = dn_layout(dec.num_denoising, dec.dn_max_gt, dec.num_queries)
        draws = {k: v.to(x.device) for k, v in draw_dn_noise(
            generator, x.shape[0], num_dn, dec.num_classes).items()}
    outputs = model(x, targets=targets, dn_draws=draws)
    losses = criterion(outputs, targets)
    total = torch.stack(list(losses.values())).sum()
    state.optimizer.zero_grad()
    total.backward()
    grad_norm = state.optimizer.step()
    state.step += 1
    if state.ema is not None:
        ema_update(state.ema, model.state_dict(), state.step, ema_momentum)
    out = {"total_loss": total.detach(), "grad_norm": grad_norm}
    out.update({k: v.detach() for k, v in losses.items()})
    return out
