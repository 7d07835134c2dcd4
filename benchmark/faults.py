"""Faults planted under the timed training step, for the check's own tests
and for reading each fault's gap on the chip (`python3 -m benchmark.control
--mode fault:<name>`). A sound check reads every one of them as not
correct."""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def unchanged_state(step: Callable) -> Callable:
    """Training: the step returns its state unchanged (it computes its
    metrics, then every parameter, EMA entry and AdamW moment is restored)."""

    def f(state, batch, gen):
        params = [p for p in state.model.parameters()]
        keep = [p.detach().clone() for p in params]
        ema = {k: v.clone() for k, v in state.ema.items()} if state.ema else None
        state, m = step(state, batch, gen)
        with torch.no_grad():
            for p, k in zip(params, keep):
                p.copy_(k)
        if ema is not None:
            state.ema = ema
        state.optimizer.adamw.state.clear()
        return state, m

    return f


def half_batch(step: Callable) -> Callable:
    """Training: half of the batch left out, the mean taken over the rest."""

    def f(state, batch, gen):
        n = batch["images"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()}, gen)

    return f


def alter_loss(step: Callable) -> Callable:
    """Training: the answer altered where it is produced: every loss the
    step returns reads 5 % high."""

    def f(state, batch, gen):
        state, m = step(state, batch, gen)
        return state, {k: (v * 1.05 if k != "grad_norm" else v) for k, v in m.items()}

    return f


def wrong_matching(step: Callable) -> Callable:
    """Training: the matcher's answer altered where it is produced: the
    port's assignment solver gives each GT the query after its optimal one
    (an off-by-one, still one query per GT)."""
    from custom_d_fine_tpu_torch.ops import hungarian

    def off_by_one(cost):
        rows, cols = solve(cost)
        return (rows + 1) % cost.shape[0], cols

    solve = hungarian.linear_sum_assignment

    def f(state, batch, gen):
        hungarian.linear_sum_assignment = off_by_one
        try:
            return step(state, batch, gen)
        finally:
            hungarian.linear_sum_assignment = solve

    return f


class _LowestTopk(TorchDispatchMode):
    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.topk.default and len(args) > 1 and args[1] == self.k:
            dim = args[2] if len(args) > 2 else kwargs.get("dim", -1)
            return func(args[0], self.k, dim, False, True)
        return func(*args, **kwargs)


def wrong_selection(step: Callable) -> Callable:
    """Training: the decoder's query selection answered wrong where it is
    produced: the top-k takes the lowest encoder scores."""

    def f(state, batch, gen):
        with _LowestTopk(state.model.decoder.num_queries):
            return step(state, batch, gen)

    return f


def wrong_masks(step: Callable) -> Callable:
    """Training with the mask head: the answer's GT altered where the step
    takes it: every GT mask rolled by 8 mask pixels along x (32 image pixels
    at a mask of a quarter of the image), so the mask losses and costs are
    taken against shifted masks."""

    def f(state, batch, gen):
        return step(state, dict(batch, masks=torch.roll(batch["masks"], 8, dims=-1)), gen)

    return f


# the faults that a cell without masks can have; a cell with them can have all
DETECT_FAULTS: Dict[str, Callable] = {"unchanged_state": unchanged_state,
                                      "half_batch": half_batch, "alter_loss": alter_loss,
                                      "wrong_matching": wrong_matching,
                                      "wrong_selection": wrong_selection}
STEP_FAULTS: Dict[str, Callable] = dict(DETECT_FAULTS, wrong_masks=wrong_masks)
