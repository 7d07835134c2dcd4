"""Optimizer: 4-group AdamW, OneCycle schedule, global-norm clipping and
gradient accumulation. Counterpart of custom_d_fine_tpu/train/optim.py
(label_params :29, onecycle :56, build_optimizer :76), which chains
optax.clip_by_global_norm, a multi_transform of per-group optax.adamw and
optax.MultiSteps; reference src/d_fine/dfine.py:87-124 and
src/dl/train.py:203-221, 512-535.

The groups (by the port's state_dict names, the reference torch names):
  backbone          backbone non-norm            backbone lr, weight decay
  backbone_norm     backbone norm                backbone lr, no decay
  encdec_norm_bias  encoder/decoder norm + bias  base lr, no decay
  rest              everything else              base lr, weight decay
  frozen            backbone stem/stages under freeze_at: never updated
Clipping is optax's clip_by_global_norm, g * min(1, max_norm / norm) over
every gradient (frozen ones too); it is not clip_grad_norm_, whose +1e-6
in the divisor differs. Accumulation is
optax.MultiSteps': a running mean of the micro-batch gradients, one clipped
AdamW step on the k-th, nothing on the others.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from ..configs.registry import ModelConfig

NORM_TOKENS = ("norm", "bn", "gn")
GROUPS = ("backbone", "backbone_norm", "encdec_norm_bias", "rest")


def param_label(name: str, model_cfg: ModelConfig) -> str:
    """The group of one parameter, from its state_dict name: the JAX
    package's label_params rule on the flax path."""
    b = model_cfg.backbone
    parts = name.split(".")
    if "backbone" in parts:
        if b.freeze_at >= 0:
            i = parts.index("backbone")
            if parts[i + 1] == "stem":
                return "frozen"
            if (not b.freeze_stem_only and parts[i + 1] == "stages"
                    and int(parts[i + 2]) <= b.freeze_at):
                return "frozen"
        return "backbone_norm" if any(t in name for t in NORM_TOKENS) else "backbone"
    if any(t in name for t in NORM_TOKENS) or name.endswith("bias"):
        return "encdec_norm_bias"
    return "rest"


def label_params(named_params: Iterable[Tuple[str, nn.Parameter]],
                 model_cfg: ModelConfig) -> Dict[str, str]:
    return {n: param_label(n, model_cfg) for n, _ in named_params}


def onecycle(max_lr: float, total_steps: int, pct_start: float) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule (torch OneCycleLR with cosine anneal,
    div_factor 25, final_div_factor 1e4) with the JAX package's guard for tiny
    runs: both phases last at least one step."""
    total_steps = max(int(total_steps), 2)
    pct = min(max(pct_start, 1.0 / total_steps), 1.0 - 1.0 / total_steps)
    bounds = [0, int(pct * total_steps), total_steps]
    values = [max_lr / 25.0, max_lr, max_lr / 25.0 / 1e4]

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                frac = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1.0)
        return values[-1]

    return schedule


class Optimizer:
    """build_optimizer's transformation on a torch model. `step()` is called
    after backward() and returns the pre-clip global gradient norm."""

    def __init__(self, model: nn.Module, model_cfg: ModelConfig, *, base_lr: float,
                 backbone_lr: float, weight_decay: float = 0.000125,
                 betas: Tuple[float, float] = (0.9, 0.999), total_steps: int = 10000,
                 pct_start: float = 0.1, clip_max_norm: float = 0.1, b_accum_steps: int = 1):
        named = list(model.named_parameters())
        labels = label_params(named, model_cfg)
        self.params: List[nn.Parameter] = [p for _, p in named]
        big = model_cfg.name in ("l", "x") or model_cfg.decoder.enable_mask_head
        peak = {"backbone": 2 * backbone_lr if big else 2 * base_lr, "rest": 2 * base_lr}
        groups = []
        for g in GROUPS:
            sched = onecycle(peak["backbone" if g.startswith("backbone") else "rest"],
                             total_steps, pct_start)
            groups.append({"params": [p for n, p in named if labels[n] == g], "name": g,
                           "schedule": sched, "lr": sched(0),
                           "weight_decay": 0.0 if g in ("backbone_norm", "encdec_norm_bias")
                           else weight_decay})
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], betas=betas,
                                       eps=1e-8)
        self.clip_max_norm = clip_max_norm
        self.k = int(b_accum_steps)
        self.count = 0       # optimizer updates so far (the schedule's step)
        self.mini_step = 0   # micro-batches accumulated towards the next update
        self.acc: List[torch.Tensor] = []

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = []
        for p in self.params:
            if p.grad is None:  # a parameter the loss did not reach: zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        if self.k > 1:  # running mean of the micro-batch gradients (optax.MultiSteps)
            if not self.acc:
                self.acc = [torch.zeros_like(g) for g in grads]
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return norm
            for p, a in zip(self.params, self.acc):
                p.grad.copy_(a)
                a.zero_()
            self.mini_step = 0
            grads = [p.grad for p in self.params]
            clip_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        else:
            clip_norm = norm
        scale = torch.where(clip_norm < self.clip_max_norm, 1.0,
                            self.clip_max_norm / clip_norm)
        torch._foreach_mul_(grads, scale)
        for g in self.adamw.param_groups:
            g["lr"] = g["schedule"](self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
