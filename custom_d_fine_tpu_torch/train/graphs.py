"""CUDA graphs of the model's static-shape front in the training step.

A training step's host dispatch, not the card, sets its time: the backbone
and the hybrid encoder alone are some 1,700 small forward and 1,400 backward
launches (every BatchNorm a handful). Their shapes are fixed by the input's,
and nothing in them reads a value back to the host, so they run here as
captured CUDA graphs, forward and backward; the decoder (its query
selection's top-k) and the criterion (the matcher's host solve) stay eager.

The units are the backbone's stem, each backbone stage and the encoder. Each
is still called through `nn.Module.__call__`: while a step's forward runs,
`FrontGraphs.engaged` sets the unit's `forward` to one that replays its
graph, so hooks on a unit fire on every replay with the replayed output. A
replay cannot call a hook on a module inside a unit, so such a unit runs
eagerly.

The graphs engage where the step can observe that they may: the input is on
the card, the model trains, grad is enabled, no other process shares the
step (under torchrun the synced BatchNorm all-reduces inside the forward),
and no capture is under way. Everything else runs eagerly: the CPU, eval,
`no_grad`, torchrun.

A key (the stem input's shape, dtype, strides and device, the autocast
state, and the units that a hook inside keeps eager) owns one memory pool
and, for each graphed unit, a forward and a backward graph. A key is
captured the first time it is seen, during that step: each unit as the
forward reaches it (warm-up on a side stream, capture, then replay), and the
backward graphs in reverse order when the forward ends, so that the captures
run in the order of the replays (forward 1..N, backward N..1), as graphs
sharing a pool must. A unit's static input is the previous unit's static
output where it is handed that tensor, so nothing is copied between them.
Warm-up leaves no trace: the unit's buffers (BatchNorm running statistics
and counters) are restored before the first replay. A pool holds the
front's activations and gradients (8.1 GB at D-FINE-m bs16 640^2, PERF.md),
so a new key is captured only while fewer than MAX_KEYS are kept and the
card has room for what the largest key's capture step took; otherwise the
step runs eagerly.

Autocast's weight cache would keep the casts of the warm-up, so warm-up and
capture run with it off (the casts are recomputed in every replay, from the
parameters as they are then); the eager rest of the step keeps it.

Gradients reach autograd as views of the backward graphs' static buffers,
as `torch.cuda.make_graphed_callables` hands them: a parameter's `.grad` may
alias a buffer that the next backward replay overwrites. The training step
sets every `.grad` to None before its backward and consumes them in its
optimizer step, so each step reads its own.

Counters: `replays`, `captures` and `eager` (units run eagerly in a step
that would graph them) count always; under the profiler the step's
`train.forward` span counts `graph_units`, `eager_units` and `captures`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn.modules import module as _module
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..parallel import dist

MAX_KEYS = 5  # keys kept for one model: the Trainer's multiscale canvases (PERF.md)
WARMUP = 2    # eager forward and backward passes of a unit before its capture

replays = 0   # unit forwards replayed
captures = 0  # units captured (a forward and a backward graph each)
eager = 0     # units run eagerly in a step that would graph them

_HOOKS = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks", "_backward_pre_hooks")
_GLOBAL_HOOKS = ("_global_forward_hooks", "_global_forward_pre_hooks",
                 "_global_backward_hooks", "_global_backward_pre_hooks")


def units(model: nn.Module) -> List[nn.Module]:
    """The graphed units of a DFINE model, in the order its forward calls them."""
    return [model.backbone.stem, *model.backbone.stages, model.encoder]


def eager_reason(model: nn.Module, x: torch.Tensor) -> Optional[str]:
    """Why a training forward of `model` on `x` runs eagerly, or None."""
    if not x.is_cuda:
        return "not on the card"
    if not model.training:
        return "eval mode"
    if not torch.is_grad_enabled():
        return "grad disabled"
    if dist.world()[0] != 1:
        return "several processes"
    if torch.cuda.is_current_stream_capturing():
        return "a capture is under way"
    return None


def hooked_inside(unit: nn.Module) -> bool:
    """A forward, forward-pre or backward hook on a module inside `unit`, or a
    global module hook: a replay could not call it."""
    if any(getattr(_module, h) for h in _GLOBAL_HOOKS):
        return True
    return any(getattr(m, h) for m in unit.modules() if m is not unit for h in _HOOKS)


def graph_key(x: torch.Tensor, eager_units: Sequence[int]) -> Tuple:
    """What a key's graphs depend on: the front's input and the autocast state
    as the step observes them, and the units it runs eagerly."""
    dev = x.device.type
    return (tuple(x.shape), x.dtype, x.stride(), x.device, torch.is_autocast_enabled(dev),
            torch.get_autocast_dtype(dev), tuple(eager_units))


def _no_weight_cache(device_type: str):
    """The step's autocast state with the weight cache off, for warm-up and capture."""
    return torch.autocast(device_type, dtype=torch.get_autocast_dtype(device_type),
                          enabled=torch.is_autocast_enabled(device_type), cache_enabled=False)


def _signature(leaves: Sequence[torch.Tensor]) -> Tuple:
    return tuple((t.shape, t.dtype, t.stride(), t.requires_grad) for t in leaves)


class _Unit:
    """One unit's graphs and static tensors under one key."""

    def __init__(self, chain: "_Chain", module: nn.Module, forward, args: Tuple):
        leaves, self.spec = tree_flatten(args)
        self.sig = _signature(leaves)
        self.inputs = tuple(chain.static_input(t) for t in leaves)
        self.params = tuple(p for p in module.parameters() if p.requires_grad)
        surface = [t for t in self.inputs if t.requires_grad] + list(self.params)
        static_args = tree_unflatten(list(self.inputs), self.spec)
        buffers = list(module.buffers())
        kept = [b.clone() for b in buffers]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                outs = [o for o in tree_flatten(forward(*static_args))[0] if o.requires_grad]
                if outs and surface:
                    torch.autograd.grad(outs, surface, [torch.ones_like(o) for o in outs],
                                        allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, pool=chain.pool):
            out = forward(*static_args)
        self.outputs, self.out_spec = tree_flatten(out)
        for b, k in zip(buffers, kept):  # through .data: the capture's backward
            b.data.copy_(k)                # saved running_mean, and checks its version
        self.bwd: Optional[torch.cuda.CUDAGraph] = None

    def capture_backward(self, pool) -> None:
        self.differentiable = [o.requires_grad for o in self.outputs]
        outs = [o for o in self.outputs if o.requires_grad]
        surface = [t for t in self.inputs if t.requires_grad] + list(self.params)
        self.grad_outputs = [torch.empty_like(o) for o in outs]
        grads = iter(())
        if outs and surface:
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=pool):
                grads = iter(torch.autograd.grad(outs, surface, self.grad_outputs,
                                                 allow_unused=True))
        self.grads = ([next(grads, None) if t.requires_grad else None for t in self.inputs]
                      + [next(grads, None) for _ in self.params])
        # free the capture's autograd graph: it holds the parameters' gradient
        # accumulators, made on the capture stream, which the replays' would be
        self.outputs = [o.detach() for o in self.outputs]

    def replay_forward(self, leaves: Sequence[torch.Tensor]) -> None:
        for s, t in zip(self.inputs, leaves):
            if s.data_ptr() != t.data_ptr():  # .data: the first step's backward
                s.data.copy_(t)               # capture checks the input's version
        self.fwd.replay()

    def replay_backward(self, grads: Sequence[torch.Tensor]) -> Tuple:
        wanted = [g for g, d in zip(grads, self.differentiable) if d]
        for s, g in zip(self.grad_outputs, wanted):
            if s.data_ptr() != g.data_ptr():
                s.copy_(g)
        if self.bwd is not None:
            self.bwd.replay()
        return tuple(None if g is None else g.detach() for g in self.grads)


class _Replay(torch.autograd.Function):
    """A unit's forward graph as an autograd node whose backward replays its
    backward graph; the inputs are the unit's leaves, then its parameters."""

    @staticmethod
    def forward(ctx, unit: _Unit, *tensors: torch.Tensor):
        ctx.unit = unit
        unit.replay_forward(tensors[:len(unit.inputs)])
        return tuple(o.detach() for o in unit.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads: torch.Tensor):
        return (None, *ctx.unit.replay_backward(grads))


class _Chain:
    """The graphed units of one key, in capture order, and their pool."""

    def __init__(self):
        self.pool = None  # made at the first capture
        self.units: Dict[int, _Unit] = {}
        self.complete = False  # the backward graphs are captured
        self.room = 0          # the card's room before the first capture
        self.need = 0          # bytes of room the capture step took

    def static_input(self, t: torch.Tensor) -> torch.Tensor:
        """A unit's static input for leaf `t`: an earlier unit's static output
        where `t` is that tensor, else a buffer the replays copy `t` into."""
        for u in self.units.values():
            for o in u.outputs:
                if (o.data_ptr() == t.data_ptr() and o.shape == t.shape
                        and o.stride() == t.stride() and o.dtype == t.dtype):
                    return o.detach().requires_grad_(t.requires_grad)
        return t.detach().clone().requires_grad_(t.requires_grad)

    def capture(self, module: nn.Module, forward, args: Tuple) -> _Unit:
        if self.pool is None:
            self.room = _room()
            self.pool = torch.cuda.graph_pool_handle()
        with _no_weight_cache("cuda"):
            return _Unit(self, module, forward, args)

    def finish(self) -> None:
        for u in reversed(list(self.units.values())):
            u.capture_backward(self.pool)
        self.complete = True
        if self.pool is not None:
            self.need = max(self.room - _room(), 0)


def _room() -> int:
    """Bytes the card can still give this process: free on the device, and
    held by the caching allocator but not allocated."""
    return (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())


def room_for_key(kept: Sequence) -> bool:
    """A new key may be captured beside the `kept` ones (each with the
    `need` its capture step took): fewer than MAX_KEYS are kept, and the
    card has room for the largest need."""
    need = max((k.need for k in kept), default=0)
    return len(kept) < MAX_KEYS and not (need and _room() < need)


class FrontGraphs:
    """The graphs of one training step function (train_step.make_train_step):
    `with graphs.engaged(model, x) as counts: model(x, ...)`."""

    def __init__(self):
        self.model: Optional[nn.Module] = None
        self.chains: Dict[Tuple, _Chain] = {}

    def chain(self, key: Tuple) -> Optional[_Chain]:
        """The key's chain; a new one while fewer than MAX_KEYS are kept and
        the card has room for the largest capture step's need; else None."""
        if key not in self.chains:
            if not room_for_key(list(self.chains.values())):
                return None
            self.chains[key] = _Chain()
        return self.chains[key]

    def engaged(self, model: nn.Module, x: torch.Tensor) -> "_Step":
        """Around the model's forward in a training step whose front input is
        `x`. The context yields the step's counts (graph_units, eager_units,
        captures), final when it exits."""
        if eager_reason(model, x) is not None:
            return _Step(self, None, [], (), None)
        if model is not self.model:  # the graphs read this model's parameters
            self.model, self.chains = model, {}
        mods = units(model)
        hooked = tuple(i for i, u in enumerate(mods) if hooked_inside(u))
        key = graph_key(x, hooked)
        chain = self.chain(key) if len(hooked) < len(mods) else None
        return _Step(self, chain, mods, hooked, key)


class _Step:
    """One step's forward with the units' `forward`s set to `call`."""

    def __init__(self, graphs: FrontGraphs, chain: Optional[_Chain], mods: List[nn.Module],
                 hooked: Tuple[int, ...], key):
        self.graphs, self.chain, self.mods, self.hooked, self.key = graphs, chain, mods, hooked, key
        self.counts = {"graph_units": 0, "eager_units": 0, "captures": 0}
        self.last = -1  # the last unit replayed: replays follow the capture order
        self.saved: List[Tuple[nn.Module, object]] = []

    def __enter__(self) -> Dict[str, int]:
        for i, u in enumerate(self.mods):
            self.saved.append((u, u.__dict__.get("forward")))
            u.forward = functools.partial(self.call, i, u, u.forward)
        return self.counts

    def __exit__(self, exc_type, *exc) -> bool:
        global replays, captures, eager
        for u, own in self.saved:
            if own is None:
                del u.forward
            else:
                u.forward = own
        chain = self.chain
        if chain is not None and not chain.complete:
            if exc_type is None:
                chain.finish()
            else:  # a capture cut short: drop the key
                self.graphs.chains.pop(self.key, None)
        replays += self.counts["graph_units"]
        captures += self.counts["captures"]
        eager += self.counts["eager_units"]
        return False

    def call(self, i: int, module: nn.Module, forward, *args):
        leaves = tree_flatten(args)[0]
        unit = self.graphed(i, module, forward, args, leaves)
        if unit is None:
            self.counts["eager_units"] += 1
            return forward(*args)
        self.last = i
        self.counts["graph_units"] += 1
        out = _Replay.apply(unit, *leaves, *unit.params)
        return tree_unflatten(list(out), unit.out_spec)

    def graphed(self, i: int, module: nn.Module, forward, args: Tuple,
                leaves: List[torch.Tensor]) -> Optional[_Unit]:
        """Unit i's graphs if this call may replay them, captured first where
        the key is new; None to run it eagerly."""
        chain = self.chain
        if chain is None or i in self.hooked or i <= self.last:
            return None
        unit = chain.units.get(i)
        if unit is None and not chain.complete:
            unit = chain.units[i] = chain.capture(module, forward, args)
            self.counts["captures"] += 1
        return unit if unit is not None and _signature(leaves) == unit.sig else None
