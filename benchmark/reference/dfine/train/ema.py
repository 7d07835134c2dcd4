"""Exponential moving average of the whole model state (parameters and
BatchNorm buffers), counterpart of custom_d_fine_tpu/train/ema.py:15-27
(reference src/dl/train.py:52-73, ModelEMA): decay = momentum *
(1 - exp(-iters / 2000)); every floating entry blends e = d*e + (1-d)*p, and
integer entries (num_batches_tracked) are copied. Updated in place.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def ema_decay(iters: int, momentum: float = 0.9998) -> float:
    return momentum * (1.0 - math.exp(-float(iters) / 2000.0))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], iters: int,
               momentum: float = 0.9998) -> None:
    """Blend `new` (a state_dict) into `ema` in place."""
    d = ema_decay(iters, momentum)
    floats = [k for k, e in ema.items() if e.is_floating_point()]
    if floats:
        e = [ema[k] for k in floats]
        torch._foreach_mul_(e, d)
        torch._foreach_add_(e, [new[k].detach().to(ema[k].dtype) for k in floats], alpha=1.0 - d)
    for k, e in ema.items():
        if not e.is_floating_point():
            e.copy_(new[k])
