"""CUDA graphs of the criterion's loss terms in the training step.

Once the matcher has returned its assignment, the criterion
(train/criterion.py:DFINECriterion.terms) is a fixed chain of gathers,
scatters and reductions under validity masks, on static shapes, that reads
nothing back to the host: some 4,500 small forward ops and 1,100
backward nodes a step at D-FINE-M, each costing the host more than the
card. So the terms run here as captured CUDA graphs, forward and backward;
the match (`DFINECriterion.match`: the costs, their copy, the host solve and
the GO union) stays eager, before it.

The graphs engage where the front's do (train/graphs.py:eager_reason, and
the same MAX_KEYS and memory rule): on the card, in a training model, with
grad enabled, in one process (under torchrun the normalisers' `global_sum`
all-reduces inside the terms) and with no capture under way. Everything
else runs the terms eagerly.

A key is what the terms' computation depends on: the structure of their
inputs (the model's outputs, the targets, assign, go_g and go_valid), each
tensor's shape, dtype, strides, device and whether it takes a gradient, the
Python values among them (up, reg_scale, num_group, the class-agnostic
flag), and the autocast state. A tensor that appears twice (the teacher
corners are the final layer's) is one input. A key owns a memory pool,
static copies of the inputs and two graphs, captured the first time it is
seen: warm-up on a side stream, the forward capture, then the backward
capture, so that the captures run in the order of the replays; then the same
step replays them. A new key is captured only while fewer than MAX_KEYS are
kept and the card has room for what the largest key's capture took.

A replay copies the step's inputs into the static ones, targets and match
included, and hands out a copy of the loss terms, so terms kept from an
earlier step keep their values. The backward replay hands autograd the
gradients of the inputs that take one as views of its static buffers; the
decoder's eager backward consumes them in the same pass (a leaf input's
`.grad` would alias a buffer that the next backward replay overwrites).

Counters: `replays`, `captures` and `eager` (the terms run eagerly by a
training step) count always; under the profiler the step's `train.loss` span
counts `graph_units` (1 when the terms replayed), `eager_units` (1 when they
ran eagerly) and `captures`. A replay runs no Python of the terms, so the
`train.loss.masks` spans inside them record only when they run eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from . import graphs

replays = 0   # terms replayed
captures = 0  # keys captured (a forward and a backward graph each)
eager = 0     # terms run eagerly by a training step

_TENSOR = object()  # marks a tensor's place in a skeleton


def _flatten(tree, tensors: List[torch.Tensor], where: Dict[int, int]):
    """A hashable skeleton of `tree` (dicts, lists, tuples): each tensor is
    replaced by its index in `tensors`, where it is put once, and every other
    leaf is kept as it is."""
    if isinstance(tree, torch.Tensor):
        if id(tree) not in where:
            where[id(tree)] = len(tensors)
            tensors.append(tree)
        return (_TENSOR, where[id(tree)])
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, tensors, where)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, tensors, where) for v in tree))
    return (None, tree)


def _unflatten(skeleton, tensors: List[torch.Tensor]):
    kind, body = skeleton
    if kind is _TENSOR:
        return tensors[body]
    if kind is dict:
        return {k: _unflatten(v, tensors) for k, v in body}
    if kind in (list, tuple):
        return kind(_unflatten(v, tensors) for v in body)
    return body


def flatten(args: Tuple) -> Tuple[Tuple, List[torch.Tensor]]:
    """(skeleton, tensors) of the terms' arguments."""
    tensors: List[torch.Tensor] = []
    return _flatten(args, tensors, {}), tensors


def loss_key(skeleton: Tuple, tensors: List[torch.Tensor]) -> Tuple:
    """What a key's graphs depend on (module docstring)."""
    dev = tensors[0].device.type
    return (skeleton,
            tuple((t.shape, t.dtype, t.stride(), t.device, t.requires_grad) for t in tensors),
            torch.is_autocast_enabled(dev), torch.get_autocast_dtype(dev))


class _Graphs:
    """One key's static inputs, graphs and pool, captured at construction
    on the inputs `tensors`."""

    def __init__(self, terms: Callable, skeleton: Tuple, tensors: List[torch.Tensor]):
        room = graphs._room()
        self.pool = torch.cuda.graph_pool_handle()
        with torch.no_grad():
            self.inputs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                               device=t.device).copy_(t) for t in tensors]
        for s, t in zip(self.inputs, tensors):
            s.requires_grad_(t.requires_grad)
        self.dest = [s.detach() for s in self.inputs]  # what the replays copy into
        surface = [s for s in self.inputs if s.requires_grad]

        def forward():
            losses = terms(*_unflatten(skeleton, self.inputs))
            return list(losses), torch.stack(list(losses.values()))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(graphs.WARMUP):
                _, out = forward()
                if out.requires_grad and surface:
                    torch.autograd.grad(out, surface, torch.ones_like(out), allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, pool=self.pool):
            self.names, out = forward()
        self.grad_out = torch.zeros_like(out)
        grads = iter(())
        self.bwd: Optional[torch.cuda.CUDAGraph] = None
        if out.requires_grad and surface:
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=self.pool):
                grads = iter(torch.autograd.grad(out, surface, self.grad_out,
                                                 allow_unused=True))
        self.grads = [next(grads, None) if s.requires_grad else None for s in self.inputs]
        self.out = out.detach()  # frees the capture's autograd graph
        self.need = max(room - graphs._room(), 0)

    def replay_forward(self, tensors) -> torch.Tensor:
        torch._foreach_copy_(self.dest, list(tensors))
        self.fwd.replay()
        return self.out.clone()

    def replay_backward(self, grad: torch.Tensor) -> Tuple:
        self.grad_out.copy_(grad)
        if self.bwd is not None:
            self.bwd.replay()
        return tuple(None if g is None else g.detach() for g in self.grads)


class _Replay(torch.autograd.Function):
    """The terms' forward graph as an autograd node whose backward replays
    their backward graph; the inputs are the key's tensors, in order."""

    @staticmethod
    def forward(ctx, graph: _Graphs, *tensors: torch.Tensor):
        ctx.graph = graph
        return graph.replay_forward(tensors)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        return (None, *ctx.graph.replay_backward(grad))


class LossGraphs:
    """The criterion's graphs of one training step function
    (train_step.make_train_step): `losses, counts = loss_graphs(model, x,
    outputs, targets)` for a step whose model forward took `x`."""

    def __init__(self, criterion):
        self.criterion = criterion
        self.keys: Dict[Tuple, _Graphs] = {}

    def graphs_for(self, key: Tuple, skeleton: Tuple, tensors: List[torch.Tensor]
                   ) -> Tuple[Optional[_Graphs], int]:
        """(the key's graphs, 1 if captured now); (None, 0) past MAX_KEYS or
        while the card has no room for the largest capture's need."""
        if key in self.keys:
            return self.keys[key], 0
        if not graphs.room_for_key(list(self.keys.values())):
            return None, 0
        self.keys[key] = _Graphs(self.criterion.terms, skeleton, tensors)
        return self.keys[key], 1

    def __call__(self, model: nn.Module, x: torch.Tensor, outputs, targets
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
        global replays, captures, eager
        args = (outputs, targets, *self.criterion.match(outputs, targets))
        graph, new = None, 0
        if graphs.eager_reason(model, x) is None:
            skeleton, tensors = flatten(args)
            graph, new = self.graphs_for(loss_key(skeleton, tensors), skeleton, tensors)
        if graph is None:
            eager += 1
            return self.criterion.terms(*args), {"graph_units": 0, "eager_units": 1,
                                                 "captures": 0}
        replays += 1
        captures += new
        flat = _Replay.apply(graph, *tensors)
        return (dict(zip(graph.names, flat.unbind())),
                {"graph_units": 1, "eager_units": 0, "captures": new})
