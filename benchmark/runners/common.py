"""Pieces the runners share: the reference model with the run's weights,
the configuration's model, and per-leaf norms."""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
import time
from typing import Any, Dict

import torch

from ..reference.dfine.configs import ModelConfig, get_model_config
from ..reference.dfine.models.dfine import DFINE
from ..weights import make_weights


class Phases:
    """Seconds of each set-up phase, printed to standard error as they end."""

    def __init__(self, what: str):
        self.what, self.t = what, time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"{self.what} set-up: {phase} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def model_config(config: Dict[str, Any]) -> ModelConfig:
    """The reference registry's entry named by the configuration file: for
    task "detect" the entry itself; for "segment" the entry with the mask
    head on and "masks" among the criterion's losses, as the port's
    get_model_config(..., enable_mask_head=True) and with_mask_losses give it
    (the registry's losses have no "masks")."""
    cfg = get_model_config(config["model_name"])
    if config["task"] == "detect":
        return cfg
    if config["task"] == "segment":
        losses = tuple(cfg.criterion.losses) + ("masks",)
        return cfg.replace(decoder=dataclasses.replace(cfg.decoder, enable_mask_head=True),
                           criterion=dataclasses.replace(cfg.criterion, losses=losses))
    raise ValueError(f"task {config['task']!r}: the reference covers detect and segment")


def mask_size(config: Dict[str, Any], img: int) -> int:
    """The side of the mask head's output for `img`-pixel images: twice the
    finest feature level (img / 4 for strides 8-32, img / 8 for 16-32)."""
    return 2 * img // model_config(config).decoder.feat_strides[0]


def config_dict(cfg: ModelConfig) -> Dict[str, Any]:
    """A ModelConfig as the nested plain dict the configuration files hold."""
    return json_ready(dataclasses.asdict(cfg))


def json_ready(x):
    if isinstance(x, dict):
        return {k: json_ready(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_ready(v) for v in x]
    return x


@contextlib.contextmanager
def strict_fp32():
    """The reference computes in f32: no TF32 in matmuls or convolutions
    inside the block; PyTorch's settings come back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's, by leaf name."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def quantile(values, q: float) -> float:
    """The q-quantile (0..1) of `values` by nearest rank."""
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(-(-q * len(s) // 1)) - 1))]


def reference_model(config: Dict[str, Any], seed: int, device, img: int) -> DFINE:
    """The plain reference model with the run's weights, made again from the
    seed (the program's copy was freed) for the traffic's image side `img`,
    in eval mode."""
    cfg = model_config(config)
    with torch.device(device):
        model = DFINE(cfg, num_classes=config["num_classes"])
    model.load_state_dict(make_weights(cfg, config["num_classes"], seed, device, img))
    return model.to(device).eval()
