"""Data-parallel training over torch.distributed: one process per card.

Counterpart of custom_d_fine_tpu/parallel/mesh.py and parallel/multihost.py
(reference src/d_fine/dist_utils.py). The JAX package runs one program over
a device mesh; GSPMD makes its sharded step equal to one process on the
global batch. The port runs `torchrun --nproc_per_node=N`, one process per
card, and keeps the same invariant by hand:

  the update of N processes, each on its 1/N of the global batch, equals the
  update of one process on the whole global batch.

Three pieces hold it, each where the quantity is computed:
  - models/layers.py:BatchNorm normalises with the global batch's mean and
    variance (all_reduce of its per-channel sum and sum of squares, with a
    backward) and keeps the flax running-statistics rule;
  - train/criterion.py divides every loss term by normalisers summed over
    the processes (`global_sum`), so each process's loss is its share of the
    global loss and the shares add up to it;
  - train/optim.py:Optimizer sums the gradients over the processes
    (`all_reduce_sum_`) before the norm and the clipping, once per
    micro-batch, so every process takes the same update.
The denoising noise of each process is its rows of the global batch's
draws (train/train_step.py). The Trainer checks the outcome after every
epoch: `check_replicas` raises unless every process holds the same model
and EMA. DistributedDataParallel is not used: the
Optimizer accumulates micro-batches itself, and frozen stages leave
parameters without gradients.

NCCL on the card, gloo on the CPU. Without a process group every function
here is the single-process identity.
"""

from __future__ import annotations

import os
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(world_size, rank) of the process group, or (1, 0) without one."""
    if is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_main_process() -> bool:
    """Rank-0 gating of logs, CSV, plots and checkpoints."""
    return world()[1] == 0


def init_from_env(device: str = "cuda") -> Tuple[int, int]:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and pin this process's card:
    NCCL when `device` is the card, gloo on the CPU. Without those variables
    (a plain `python -m ...`) no group is made. Returns (world_size, rank)."""
    if is_initialized() or "WORLD_SIZE" not in os.environ:
        return world()
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if on_card else "gloo", init_method="env://")
    return world()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of a tensor over the processes, for normalisers (no gradient)."""
    if world()[0] == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor over the processes in place, through one flat
    buffer per dtype (one collective for all the gradients)."""
    if world()[0] == 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


def batch_rows(n: int) -> Tuple[int, int]:
    """(first row, global rows) of this process's `n` rows in the global
    batch, in rank order; (0, n) without a process group. Takes every
    process to hold `n` rows, as the train split gives them (drop_last,
    wrap-padded), so nothing is exchanged. A batch that is short on one
    process (ignore_background_epochs drops background images) only shifts
    which denoising draws that process keeps; no collective depends on it."""
    size, rank = world()
    return rank * n, size * n


def check_replicas(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise on every process unless all of them hold the same `tensors`,
    compared by the float64 sum of each tensor, gathered over the processes.
    Nothing to compare without a process group."""
    size, _ = world()
    if size == 1:
        return
    sums = torch.stack([t.detach().double().sum() for t in tensors])
    parts = [torch.empty_like(sums) for _ in range(size)]
    dist.all_gather(parts, sums)
    differ = [r for r, p in enumerate(parts) if not torch.equal(p, parts[0])]
    if differ:
        raise RuntimeError(f"{what} differ between process 0 and processes {differ}")


def gather_objects(local_items: List[Any]) -> List[Any]:
    """Concatenate per-process lists of picklable objects in rank order
    (all_gather_object); the identity without a process group."""
    n, _ = world()
    if n == 1:
        return local_items
    out: List[Any] = [None] * n
    dist.all_gather_object(out, local_items)
    return [x for part in out for x in part]

