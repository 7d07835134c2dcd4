"""Int8 weight quantization with accuracy control (PyTorch), counterpart of
custom_d_fine_tpu/deploy/quantize.py.

Parity target: reference src/dl/ov_int8.py:18-163 (NNCF
quantize_with_accuracy_control: calibrate, quantize, validate with the full
F1 pipeline, revert until the F1 drop fits the max_drop budget).

The weights whose flax counterpart (through utils/weights.flax_to_torch) is
a `kernel` leaf with ndim >= 2 are stored as per-output-channel symmetric
int8 with an f32 scale: conv and Linear weights, and the packed MHA
in_proj_weight, whose rows are the JAX package's separate q/k/v Dense
kernels. flax's output axis is its last; in torch it is axis 0 of a Conv2d
[O, I, kh, kw] and of a Linear [out, in]. nn.Embedding tables (flax
`embedding`) and 1-D tensors stay f32. The int8 tensors are dequantized in
every forward (`q.float() * scale`), as the JAX graph does inside jit; they
are never folded back to f32 at load.

A quantized state dict holds `<name>@q` (int8) and `<name>@scale` (f32 [O])
in place of `<name>`, as the JAX package's qparams hold `kernel@q` and
`kernel@scale`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

import torch
from torch import nn


def quantizable_names(model: nn.Module) -> List[str]:
    """The parameter names of `model` that int8 quantization stores as int8:
    every parameter of ndim >= 2 except nn.Embedding tables."""
    out = []
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.Embedding):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if p.ndim >= 2:
                out.append(f"{mod_name}.{name}" if mod_name else name)
    return out


def quantize_leaf(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (axis 0) symmetric int8 quantization -> (q int8 with
    w's shape, scale f32 [O]). Rounds half to even, as np.round does."""
    w = w.detach().float()
    amax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / _bcast(scale, w)), -127, 127).to(torch.int8)
    return q, scale


def _bcast(scale: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return scale.reshape(-1, *([1] * (w.ndim - 1)))


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * _bcast(scale, q)


def quantization_error(w: torch.Tensor) -> float:
    """Mean absolute dequantization error relative to the mean |w|."""
    w = w.detach().float()
    deq = dequantize_leaf(*quantize_leaf(w))
    return float((deq - w).abs().mean()) / (float(w.abs().mean()) + 1e-12)


def quantize_params(state: Mapping[str, torch.Tensor], names: Iterable[str],
                    skip: Optional[Set[str]] = None
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(quantized state dict, the names quantized): each of `names` not in
    `skip` becomes `<name>@q` and `<name>@scale`; every other entry is kept."""
    skip = skip or set()
    todo = set(names) - skip
    out, quantized = {}, []
    for k, v in state.items():
        if k not in todo:
            out[k] = v
            continue
        out[k + "@q"], out[k + "@scale"] = quantize_leaf(v)
        quantized.append(k)
    return out, quantized


def dequantize_params(qstate: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse transform: int8 entries -> f32 weights (run in every forward)."""
    out = {}
    for k, v in qstate.items():
        if k.endswith("@q"):
            out[k[:-2]] = dequantize_leaf(v, qstate[k[:-2] + "@scale"])
        elif not k.endswith("@scale"):
            out[k] = v
    return out


class QuantizedWeights(nn.Module):
    """The int8 entries of a quantized state dict (`<name>@q` int8 and
    `<name>@scale` f32) as buffers of a module, so that they move with
    .to(device) and ride inside an exported graph; calling it gives {name:
    dequantized f32 weight}."""

    def __init__(self, qstate: Dict[str, torch.Tensor]):
        super().__init__()
        self.names = sorted(k[:-2] for k in qstate if k.endswith("@q"))
        for i, k in enumerate(self.names):
            self.register_buffer(f"q{i}", qstate[k + "@q"])
            self.register_buffer(f"scale{i}", qstate[k + "@scale"])

    def forward(self) -> Dict[str, torch.Tensor]:
        return {k: dequantize_leaf(getattr(self, f"q{i}"), getattr(self, f"scale{i}"))
                for i, k in enumerate(self.names)}


def make_quantized_apply(model: nn.Module) -> Callable:
    """apply_fn(qstate, *args, **kwargs): `model` run with the weights of
    `qstate`, the quantized ones dequantized on the fly."""

    def apply_fn(qstate, *args, **kwargs):
        return torch.func.functional_call(model, dequantize_params(qstate), args, kwargs)

    return apply_fn


def quantize_with_accuracy_control(
    state: Mapping[str, torch.Tensor],
    names: Sequence[str],
    validate_fn: Callable[[Dict[str, torch.Tensor]], float],
    max_drop: float = 0.02,
    max_reverts: int = 20,
):
    """Greedy accuracy-controlled quantization (reference ov_int8.py:18-163):
    quantize every one of `names`, then un-quantize the highest-error ones
    until the metric drop fits the budget. validate_fn receives a state dict
    where quantized weights appear as `@q`/`@scale` pairs (consume it with
    make_quantized_apply or dequantize_params). Returns (qstate, report)."""
    baseline = float(validate_fn(dict(state)))
    errors = {k: quantization_error(state[k]) for k in names}
    order = sorted(errors, key=lambda k: -errors[k])  # most sensitive first

    skip: Set[str] = set()
    qstate, quantized = quantize_params(state, names, skip)
    metric = float(validate_fn(qstate))
    reverted: List[str] = []
    while baseline - metric > max_drop and len(reverted) < max_reverts and order:
        worst = order.pop(0)
        skip.add(worst)
        reverted.append(worst)
        qstate, quantized = quantize_params(state, names, skip)
        metric = float(validate_fn(qstate))

    report = {
        "baseline_metric": baseline,
        "quantized_metric": metric,
        "drop": baseline - metric,
        "n_quantized": len(quantized),
        "n_reverted": len(reverted),
        "reverted": reverted,
    }
    return qstate, report
