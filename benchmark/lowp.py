"""The training cell's control: the reference computed in fp8, the next
precision below the bf16 autocast that the configuration states. Inside the
model's forward (the region the program autocasts), every convolution,
linear map, einsum and matmul takes its operands rounded to float8_e4m3fn
with one scale per tensor (amax / 448) and rounds its output the same way,
and every leaf module's output (the activations that pass between layers,
which autocast keeps in its low precision) is rounded too; the criterion
stays f32, as in the program. Gradients pass the rounding straight through.
With the mask head, its convs and its queries-by-features matmul are rounded
by the mode and its GroupNorms' outputs by the leaf hooks; under the bf16
witness (`ref-bf16`) autocast runs the convs and the matmul in bf16 and the
GroupNorms in f32, as it does in the program.
(Rounding every op's output, divisions and logs included, turns the loss
into NaN: fp8 has no room for the reciprocals and logits of a D-FINE.)"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0


INT8_MAX = 127.0


def int8_round(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with one scale per tensor (amax / 127); the gradient
    passes straight through."""
    if not t.is_floating_point():
        return t
    scale = t.detach().abs().amax().float().clamp(min=1e-12) / INT8_MAX
    q = torch.round(t.detach().float() / scale).clamp_(-INT8_MAX, INT8_MAX) * scale
    return t + (q.to(t.dtype) - t.detach())


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    scale = t.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t.detach())


class Fp8Compute(TorchFunctionMode):
    rnd = staticmethod(fp8_round)
    OPS = {F.conv2d, F.linear, torch.einsum, torch.matmul, torch.bmm, torch.mm,
           torch.Tensor.matmul, torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            if func is torch.einsum:
                args = (args[0], *[self.rnd(a) for a in args[1:]])
            else:
                args = tuple(self.rnd(a) if isinstance(a, torch.Tensor) else a
                             for a in args[:2]) + tuple(args[2:])
            out = func(*args, **kwargs)
            return self.rnd(out) if isinstance(out, torch.Tensor) else out
        return func(*args, **kwargs)


class Int8Compute(Fp8Compute):
    rnd = staticmethod(int8_round)


def round_leaf_outputs(model: torch.nn.Module, rnd=fp8_round):
    """Forward hooks that round every leaf module's tensor output with
    `rnd`; returns the handles."""
    def hook(_mod, _inp, out):
        return rnd(out) if isinstance(out, torch.Tensor) else out

    return [m.register_forward_hook(hook) for m in model.modules()
            if not list(m.children())]
