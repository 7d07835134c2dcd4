"""Helpers for the CPU tests of the training step's CUDA graphs
(custom_d_fine_tpu_torch/train/graphs.py): a card emulated on the CPU, what
`eager_reason` reads of a card tensor, batches for `build_training`, and
tiny models with their criterion.

The emulated card records the aten ops a capture runs and reruns them on
replay into the tensors the capture produced, as a CUDA graph does into its
static memory, so the whole mechanism (warm-up, capture, static inputs,
replay forward and backward) runs on the CPU and can be held to eager steps
bitwise. tests/test_torch_cuda.py holds the real graphs on the card."""

import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from custom_d_fine_tpu_torch.models.denoising import dn_layout, draw_dn_noise
from custom_d_fine_tpu_torch.models.dfine import build_model
from custom_d_fine_tpu_torch.train import graphs
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion, with_mask_losses

from helpers import tiny_config
from torch_jax_models import port_config

ON_CARD = SimpleNamespace(is_cuda=True)  # what eager_reason reads of a card tensor
NC = 4
CASES = ("detect", "segment", "agnostic")


class _Recording(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _EmulatedGraph:
    """A CUDA graph on the CPU: capture records the aten ops and the tensors
    they produced; replay runs them again below autograd (no version counts)
    and writes each result into the tensor the capture produced, so later ops
    and the caller read it there, as from a graph's static memory."""

    def __init__(self):
        self.ops = []

    def replay(self):
        with torch._C._AutoDispatchBelowADInplaceOrView(), torch.no_grad():
            for func, args, kwargs, out in self.ops:
                for o, n in zip(tree_flatten(out)[0], tree_flatten(func(*args, **kwargs))[0]):
                    if isinstance(o, torch.Tensor) and o.data_ptr() != n.data_ptr():
                        o.data.copy_(n)


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def emulated_card(monkeypatch):
    """torch.cuda's graph and stream calls as graphs.py makes them, on the CPU,
    with torch at one intra-op thread: the emulated card runs thousands of
    tiny ops, and on a loaded host a pool of threads waits on each."""
    @contextlib.contextmanager
    def capture(graph, pool=None):
        with _Recording(graph.ops):
            yield

    for name, value in {"CUDAGraph": _EmulatedGraph, "graph": capture,
                        "graph_pool_handle": lambda: (0, 1), "Stream": _Stream,
                        "stream": lambda s: contextlib.nullcontext(),
                        "current_stream": _Stream}.items():
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(graphs, "eager_reason", lambda m, x: (
        None if m.training and torch.is_grad_enabled() else "eval or no grad"))
    monkeypatch.setattr(graphs, "_room", lambda: 1 << 40)
    monkeypatch.setattr(graphs, "_no_weight_cache", lambda device_type: contextlib.nullcontext())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(cfg, n, B=2, img=160):
    """`n` training batches of `cfg` for build_training, uint8 images."""
    rng = np.random.default_rng(0)
    G = cfg.max_gt
    out = []
    for _ in range(n):
        valid = np.arange(G)[None] < rng.integers(1, 6, (B, 1))
        boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)),
                                rng.uniform(0.1, 0.2, (B, G, 2))], -1)
        out.append({"images": torch.from_numpy(rng.integers(0, 256, (B, img, img, 3),
                                                            dtype=np.uint8)),
                    "labels": torch.from_numpy(rng.integers(0, NC, (B, G))),
                    "boxes": torch.from_numpy(boxes.astype(np.float32)),
                    "valid": torch.from_numpy(valid)})
    return out


def config(case):
    """tiny_config for `case`: detect, segment (the mask head) or agnostic
    (the class-agnostic query selection)."""
    cfg = port_config(tiny_config(enable_mask_head=case == "segment"))
    if case == "agnostic":
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, query_select_method="agnostic"))
    return cfg


class TinyCase:
    """A tiny model in train mode and its criterion."""

    def __init__(self, case):
        self.cfg = config(case)
        self.model = build_model(self.cfg, num_classes=NC, seed=0).train()
        crit = self.cfg.criterion
        if self.cfg.decoder.enable_mask_head:
            crit = with_mask_losses(crit)
        self.criterion = DFINECriterion(crit, self.cfg.matcher, num_classes=NC)

    def step_inputs(self, seed=0, B=2, G=None, img=160, image_valid=False):
        """(x, outputs, targets) of one training forward."""
        rng = np.random.default_rng(seed)
        G = G or self.cfg.max_gt
        valid = np.arange(G)[None] < rng.integers(1, min(G, 6), (B, 1))
        boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)),
                                rng.uniform(0.1, 0.2, (B, G, 2))], -1)
        targets = {"labels": torch.from_numpy(rng.integers(0, NC, (B, G))),
                   "boxes": torch.from_numpy(boxes.astype(np.float32)),
                   "valid": torch.from_numpy(valid)}
        if image_valid:
            targets["image_valid"] = torch.tensor([True] * (B - 1) + [False])
        if self.cfg.decoder.enable_mask_head:
            hm = 2 * img // 16  # twice the finest level (stride 16)
            m = (rng.uniform(size=(B, G, hm, hm)) < 0.3) & valid[..., None, None]
            targets["masks"] = torch.from_numpy(m.astype(np.uint8))
        x = torch.from_numpy(rng.uniform(0, 1, (B, 3, img, img)).astype(np.float32))
        dec = self.model.decoder
        _, num_dn, _ = dn_layout(dec.num_denoising, dec.dn_max_gt, dec.num_queries)
        draws = draw_dn_noise(torch.Generator().manual_seed(seed), B, num_dn, NC)
        return x, self.model(x, targets=targets, dn_draws=draws), targets


@pytest.fixture(scope="module")
def cases():
    """A TinyCase of each of CASES, built once a module."""
    return {c: TinyCase(c) for c in CASES}
