"""CUDA graphs in the training step, at two sites: the model's front and
the criterion's loss terms.

A training step's host dispatch, not the card, sets its time. Two parts of
it are long chains of small launches on shapes fixed by the input's that
read nothing back to the host; they replay as CUDA graphs, forward and
backward, in graphed units:
- the front: the backbone's stem, each backbone stage and the hybrid
  encoder, a unit each (at D-FINE-M some 1,700 small forward and 1,400
  backward launches). A unit is still called through `nn.Module.__call__`:
  while a step's forward runs, `StepGraphs.engaged` sets its `forward` to
  one that replays its graph, so hooks on a unit fire on every replay with
  the replayed output. A replay cannot call a hook on a module inside a
  unit, so such a unit runs eagerly. The decoder (its top-k) stays eager.
- the loss terms, one unit: after the eager match (`DFINECriterion.match`:
  the costs, their copy, the host solve, the GO union),
  `DFINECriterion.terms` is a fixed chain of gathers, scatters and
  reductions under validity masks (some 4,500 small forward ops and 1,100
  backward nodes), captured returning the terms stacked.

Both sites engage only where the step can observe that they may
(`eager_reason`): on the card, in training, with grad, in one process (under
torchrun the synced BatchNorm and the normalisers' `global_sum` all-reduce
inside them) and outside a capture.

A unit's arguments flatten into a skeleton and its tensors: a tensor that
appears twice is one input, and Python values stay in the skeleton. A key
is the signature (shape, dtype, strides, device, grad flag) of a site's
tensors (the front's: the stem's input), the autocast state, and the
front's units that a hook inside keeps eager, or the terms' skeleton. A key
owns a memory pool and, for each unit, a forward and a backward graph,
captured the step the key is first seen: each unit's warm-up on a side
stream, forward capture and replay, then the backward graphs in reverse
order when the site's forward has ended, so that the captures run in the
order of the replays, as graphs sharing a pool must. A unit's static input
is an earlier unit's static output where it is handed that very tensor (the
front's units chain without copies); a replay copies the other tensors into
their static inputs in one launch. Warm-up leaves a unit's buffers
(BatchNorm statistics) as it found them, and runs, as the capture does,
with autocast's weight cache off: the casts are recomputed in every replay.

A pool holds what its captures allocated (the front's: 8.1 GB at D-FINE-M
bs16 640^2, PERF.md), so each site captures a new key only while it keeps
fewer than MAX_KEYS and the card has room for what its largest key's
capture took; otherwise that step runs the site eagerly.

The terms' call hands out a copy of the replayed outputs, so terms kept
from an earlier step keep their values. Gradients reach autograd as views of
the backward graphs' static buffers (as `make_graphed_callables` hands
them): a `.grad` may alias a buffer that the next backward replay
overwrites. Each step reads its own: the training step sets every `.grad`
to None before its backward and consumes them in its optimizer step, and
the decoder's eager backward consumes the terms' gradients in that pass.

Each site (`StepGraphs.front`, `.loss`) counts `replays`, `captures` and
`eager` (units run eagerly in a step that would graph them); the profiled
`train.forward` and `train.loss` spans count `graph_units`, `eager_units`
and `captures`. A replay runs no Python: spans inside the terms
(`train.loss.masks`) record only when they run eagerly.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn.modules import module as _module

from ..parallel import dist

MAX_KEYS = 5  # keys kept by a site: the Trainer's multiscale canvases (PERF.md)
WARMUP = 2    # eager forward and backward passes of a unit before its capture

_HOOKS = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks", "_backward_pre_hooks")
_GLOBAL_HOOKS = ("_global_forward_hooks", "_global_forward_pre_hooks",
                 "_global_backward_hooks", "_global_backward_pre_hooks")
_TENSOR = object()  # marks a tensor's place in a skeleton


def _flatten(tree, tensors: List[torch.Tensor], where: Dict[int, int]):
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


def flatten(tree) -> Tuple[Tuple, List[torch.Tensor]]:
    """(skeleton, tensors) of `tree` (dicts, lists, tuples): a hashable
    skeleton in which each tensor is its index in `tensors`, where it is put
    once, and every other leaf is kept as it is."""
    tensors: List[torch.Tensor] = []
    return _flatten(tree, tensors, {}), tensors


def unflatten(skeleton: Tuple, tensors: Sequence[torch.Tensor]):
    kind, body = skeleton
    if kind is _TENSOR:
        return tensors[body]
    if kind is dict:
        return {k: unflatten(v, tensors) for k, v in body}
    if kind in (list, tuple):
        return kind(unflatten(v, tensors) for v in body)
    return body


def signature(tensors: Sequence[torch.Tensor]) -> Tuple:
    """What a graph reads of its tensors: shape, dtype, strides, device and
    grad flag of each."""
    return tuple((t.shape, t.dtype, t.stride(), t.device, t.requires_grad) for t in tensors)


def graph_key(tensors: Sequence[torch.Tensor], *rest) -> Tuple:
    """What a key's graphs depend on: the signature of its tensors, the
    autocast state on their device as the step observes it, and `rest`."""
    dev = tensors[0].device.type
    return (signature(tensors), torch.is_autocast_enabled(dev), torch.get_autocast_dtype(dev),
            *rest)


def units(model: nn.Module) -> List[nn.Module]:
    """The graphed units of a DFINE model's front, in the order its forward calls them."""
    return [model.backbone.stem, *model.backbone.stages, model.encoder]


def eager_reason(model: nn.Module, x: torch.Tensor) -> Optional[str]:
    """Why a training step of `model` on `x` runs its graphed sites eagerly, or None."""
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


def _no_weight_cache(device_type: str):
    """The step's autocast state with the weight cache off, for warm-up and capture."""
    return torch.autocast(device_type, dtype=torch.get_autocast_dtype(device_type),
                          enabled=torch.is_autocast_enabled(device_type), cache_enabled=False)


def _room() -> int:
    """Bytes the card can still give this process: free on the device, and
    held by the caching allocator but not allocated."""
    return (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())


class Graphed:
    """One unit's static inputs, forward and backward graphs and gradient
    buffers under one key. The autograd surface is the inputs that take a
    gradient, then `params`."""

    def __init__(self, tensors: Sequence[torch.Tensor], earlier: Sequence["Graphed"],
                 params: Sequence[torch.Tensor] = ()):
        self.sig = signature(tensors)
        self.inputs = [self._static_input(t, earlier) for t in tensors]
        self.dest = [s.data for s in self.inputs]  # .data: copies leave the version alone
        self.params = tuple(params)
        self.surface = [s for s in self.inputs if s.requires_grad] + list(self.params)
        self.bwd: Optional[torch.cuda.CUDAGraph] = None

    @staticmethod
    def _static_input(t: torch.Tensor, earlier: Sequence["Graphed"]) -> torch.Tensor:
        """An earlier unit's static output where `t` is that tensor, else a
        buffer the replays copy `t` into."""
        for g in earlier:
            for o in g.outputs:
                if (o.data_ptr() == t.data_ptr() and o.shape == t.shape
                        and o.stride() == t.stride() and o.dtype == t.dtype):
                    return o.detach().requires_grad_(t.requires_grad)
        with torch.no_grad():
            s = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)
        return s.requires_grad_(t.requires_grad)

    def capture_forward(self, fn: Callable, skeleton: Tuple, pool,
                        buffers: Sequence[torch.Tensor] = ()) -> None:
        """`fn` on the static inputs laid out as `skeleton`: WARMUP eager
        forward and backward passes on a side stream, then the forward
        graph in `pool`; `buffers` are left as they were."""
        args = unflatten(skeleton, self.inputs)
        kept = [b.clone() for b in buffers]
        with _no_weight_cache("cuda"):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    outs = [o for o in flatten(fn(*args))[1] if o.requires_grad]
                    if outs and self.surface:
                        torch.autograd.grad(outs, self.surface, [torch.ones_like(o) for o in outs],
                                            allow_unused=True)
            torch.cuda.current_stream().wait_stream(side)
            self.fwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.fwd, pool=pool):
                self.out_skeleton, self.outputs = flatten(fn(*args))
        for b, k in zip(buffers, kept):  # through .data: the capture's backward
            b.data.copy_(k)                # saved running_mean, and checks its version

    def capture_backward(self, pool) -> None:
        self.differentiable = [o.requires_grad for o in self.outputs]
        outs = [o for o in self.outputs if o.requires_grad]
        self.grad_outputs = [torch.empty_like(o) for o in outs]
        grads = iter(())
        if outs and self.surface:
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=pool):
                grads = iter(torch.autograd.grad(outs, self.surface, self.grad_outputs,
                                                 allow_unused=True))
        self.grads = ([next(grads, None) if t.requires_grad else None for t in self.inputs]
                      + [next(grads, None) for _ in self.params])
        # free the capture's autograd graph: it holds the parameters' gradient
        # accumulators, made on the capture stream, which the replays' would be
        self.outputs = [o.detach() for o in self.outputs]

    def replay_forward(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        moved = [(s, t) for s, t in zip(self.dest, tensors) if s.data_ptr() != t.data_ptr()]
        if moved:
            torch._foreach_copy_([s for s, _ in moved], [t for _, t in moved])
        self.fwd.replay()
        return self.outputs

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
    backward graph; the inputs are the unit's tensors, then its parameters."""

    @staticmethod
    def forward(ctx, unit: Graphed, *tensors: torch.Tensor):
        ctx.unit = unit
        return tuple(o.detach() for o in unit.replay_forward(tensors[:len(unit.inputs)]))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads: torch.Tensor):
        return (None, *ctx.unit.replay_backward(grads))


class Chain:
    """The graphed units of one key, in capture order, and their pool."""

    def __init__(self):
        self.pool = None  # made at the first capture
        self.units: Dict[int, Graphed] = {}
        self.complete = False  # the backward graphs are captured
        self.room = 0          # the card's room before the first capture
        self.need = 0          # bytes of room the key's capture took

    def capture(self, i: int, fn: Callable, skeleton: Tuple, tensors: Sequence[torch.Tensor],
                params: Sequence[torch.Tensor] = (), buffers: Sequence[torch.Tensor] = ()
                ) -> Graphed:
        """Unit i's forward graph: `fn` on `tensors` laid out as `skeleton`."""
        if self.pool is None:
            self.room = _room()
            self.pool = torch.cuda.graph_pool_handle()
        unit = Graphed(tensors, list(self.units.values()), params)
        unit.capture_forward(fn, skeleton, self.pool, buffers)
        self.units[i] = unit
        return unit


class Keys:
    """One site's chains by key, and its counters."""

    def __init__(self):
        self.chains: Dict[Tuple, Chain] = {}
        self.replays = 0   # units replayed
        self.captures = 0  # units captured (a forward and a backward graph each)
        self.eager = 0     # units run eagerly in a step that would graph them

    def chain(self, key: Tuple) -> Optional[Chain]:
        """The key's chain; a new one, kept once its capture completes, while
        fewer than MAX_KEYS are kept and the card has room for the largest
        need among them; else None."""
        if key in self.chains:
            return self.chains[key]
        need = max((c.need for c in self.chains.values()), default=0)
        if len(self.chains) >= MAX_KEYS or (need and _room() < need):
            return None
        return Chain()

    def finish(self, key: Tuple, chain: Chain) -> None:
        """Capture the chain's backward graphs, in reverse order, and keep it."""
        for u in reversed(list(chain.units.values())):
            u.capture_backward(chain.pool)
        chain.complete = True
        if chain.pool is not None:
            chain.need = max(chain.room - _room(), 0)
        self.chains[key] = chain

    def tally(self, counts: Dict[str, int]) -> Dict[str, int]:
        self.replays += counts["graph_units"]
        self.captures += counts["captures"]
        self.eager += counts["eager_units"]
        return counts


class StepGraphs:
    """The graphs of one training step function (train_step.make_train_step):
    `with graphs.engaged(model, x) as counts: outputs = model(x, ...)`, then
    `losses, counts = graphs.loss_terms(model, x, outputs, targets)`."""

    def __init__(self, criterion):
        self.criterion = criterion
        self.model: Optional[nn.Module] = None
        self.front, self.loss = Keys(), Keys()

    def engaged(self, model: nn.Module, x: torch.Tensor) -> "_Front":
        """Around the model's forward in a training step whose front input is
        `x`. The context yields the step's counts (graph_units, eager_units,
        captures), final when it exits."""
        if eager_reason(model, x) is not None:
            return _Front(self.front, None, [], (), None)
        if model is not self.model:  # the graphs read this model's parameters
            self.model, self.front.chains = model, {}
        mods = units(model)
        hooked = tuple(i for i, u in enumerate(mods) if hooked_inside(u))
        key = graph_key([x], hooked)
        chain = self.front.chain(key) if len(hooked) < len(mods) else None
        return _Front(self.front, chain, mods, hooked, key)

    def loss_terms(self, model: nn.Module, x: torch.Tensor, outputs, targets
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
        """The criterion's loss terms for a step whose model forward took
        `x`, and their counts: the match eagerly, the terms replayed."""
        args = (outputs, targets, *self.criterion.match(outputs, targets))
        chain = None
        if eager_reason(model, x) is None:
            skeleton, tensors = flatten(args)
            key = graph_key(tensors, skeleton)
            chain = self.loss.chain(key)
        if chain is None:
            return self.criterion.terms(*args), self.loss.tally(
                {"graph_units": 0, "eager_units": 1, "captures": 0})
        new = int(not chain.complete)
        if new:
            def stacked(*a):  # the terms' names, and their values stacked
                losses = self.criterion.terms(*a)
                return tuple(losses), torch.stack(list(losses.values()))
            chain.capture(0, stacked, skeleton, tensors)
            self.loss.finish(key, chain)
        unit = chain.units[0]
        names, stacked = unflatten(unit.out_skeleton, _Replay.apply(unit, *tensors))
        return (dict(zip(names, stacked.clone().unbind())),
                self.loss.tally({"graph_units": 1, "eager_units": 0, "captures": new}))


class _Front:
    """One step's forward with the front units' `forward`s set to `call`."""

    def __init__(self, keys: Keys, chain: Optional[Chain], mods: List[nn.Module],
                 hooked: Tuple[int, ...], key):
        self.keys, self.chain, self.mods, self.hooked, self.key = keys, chain, mods, hooked, key
        self.counts = {"graph_units": 0, "eager_units": 0, "captures": 0}
        self.last = -1  # the last unit replayed: replays follow the capture order
        self.saved: List[Tuple[nn.Module, object]] = []

    def __enter__(self) -> Dict[str, int]:
        for i, u in enumerate(self.mods):
            self.saved.append((u, u.__dict__.get("forward")))
            u.forward = functools.partial(self.call, i, u, u.forward)
        return self.counts

    def __exit__(self, exc_type, *exc) -> bool:
        for u, own in self.saved:
            if own is None:
                del u.forward
            else:
                u.forward = own
        if self.chain is not None and not self.chain.complete and exc_type is None:
            self.keys.finish(self.key, self.chain)  # a capture cut short is not kept
        self.keys.tally(self.counts)
        return False

    def call(self, i: int, module: nn.Module, forward, *args):
        """Unit i replayed, captured first where the key is new, or run eagerly."""
        skeleton, tensors = flatten(args)
        chain, unit = self.chain, None
        if chain is not None and i not in self.hooked and i > self.last:
            unit = chain.units.get(i)
            if unit is None and not chain.complete:
                unit = chain.capture(i, forward, skeleton, tensors,
                                     [p for p in module.parameters() if p.requires_grad],
                                     list(module.buffers()))
                self.counts["captures"] += 1
        if unit is None or signature(tensors) != unit.sig:
            self.counts["eager_units"] += 1
            return forward(*args)
        self.last = i
        self.counts["graph_units"] += 1
        return unflatten(unit.out_skeleton, _Replay.apply(unit, *tensors, *unit.params))
