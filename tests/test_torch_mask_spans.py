"""The spans of the mask head, its matching costs and its losses
(utils/profiling.py) on the CPU: one training step of
tests/helpers.py:tiny_config with the mask head on (160^2, batch 2, f32,
masks at 20^2) and one without it, under torch.profiler. Each mask span is
recorded inside its parent as often as the step runs its code, its counts
are the shapes' (the mask costs' and the matcher's copy's over the valid
GT rows), an eval forward records the head's span too, and a detect step
records none of them."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from custom_d_fine_tpu_torch.models.denoising import dn_layout
from custom_d_fine_tpu_torch.train import train_step as ttrain
from custom_d_fine_tpu_torch.utils.profiling import clear_spans, spans

from helpers import tiny_config
from torch_jax_models import port_config
from torch_threads import few_threads  # noqa: F401  (autouse)

IMG, B, NC = 160, 2, 4
HM = 2 * IMG // 16  # twice the finest level (stride 16)
N_VALID = np.array([3, 5])
MASK_SPANS = ("model.mask_head", "train.match.mask_costs", "train.loss.masks")
PARENT = {"model.mask_head": "train.forward", "train.match.mask_costs": "train.match.costs",
          "train.loss.masks": "train.loss"}


def make_batch(G, masks):
    rng = np.random.default_rng(0)
    valid = np.arange(G)[None] < N_VALID[:, None]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)), rng.uniform(0.1, 0.2, (B, G, 2))], -1)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, NC, (B, G))),
             "boxes": torch.from_numpy(boxes.astype(np.float32)),
             "valid": torch.from_numpy(valid)}
    if masks:
        m = (rng.uniform(size=(B, G, HM, HM)) < 0.3) & valid[..., None, None]
        batch["masks"] = torch.from_numpy(m.astype(np.uint8))
    return batch


def profiled_step(enable_mask_head):
    cfg = port_config(tiny_config(enable_mask_head=enable_mask_head))
    step, state = ttrain.build_training(cfg, NC, device="cpu", bf16=False, seed=0)
    batch = make_batch(cfg.max_gt, enable_mask_head)
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch, torch.Generator().manual_seed(0))
    out = SimpleNamespace(cfg=cfg, state=state, batch=batch, spans=spans())
    clear_spans()
    return out


@pytest.fixture(scope="module")
def seg():
    return profiled_step(True)


@pytest.fixture(scope="module")
def det():
    return profiled_step(False)


def runs(cfg):
    """How often the step runs each span's code: the head once, the mask
    costs on the final and aux sets, the crops on those and on the dn sets
    but the last plus dn_pred_masks."""
    L = cfg.decoder.num_layers
    return {"model.mask_head": 1, "train.match.mask_costs": L, "train.loss.masks": 2 * L}


@pytest.mark.parametrize("name", MASK_SPANS)
def test_each_mask_span_inside_its_parent(seg, name):
    by_seq = {s.seq: s for s in seg.spans}
    got = [s for s in seg.spans if s.name == name]
    assert len(got) == runs(seg.cfg)[name]
    for s in got:
        parent = by_seq[s.parent]
        assert parent.name == PARENT[name] and by_seq[s.step].name == "train.step"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_mask_counts_are_the_shapes(seg):
    d, G = seg.cfg.decoder, seg.cfg.max_gt
    Q, L = d.num_queries, d.num_layers
    num_group, num_dn, _ = dn_layout(d.num_denoising, seg.cfg.dn_max_gt, Q)
    n, px = int(N_VALID.sum()), HM * HM
    counts = {}
    for s in seg.spans:
        counts.setdefault(s.name, []).append(s.counts)
    assert counts["model.mask_head"] == [{"layers": L, "rows": L * B * (num_dn + Q),
                                          "pixels": B * px}]
    assert counts["train.match.mask_costs"] == [
        {"sets": 1, "cells": Q * n * px, "gt_rows": n}] * L
    (copy,) = counts["train.match.copy"]
    assert copy["valid_gt_rows"] == n
    m_dn = num_group * seg.cfg.dn_max_gt  # the positive dn slots, all valid: each image has GT
    matched = {"masks": B * G, "pixels": B * G * px}
    dn = {"masks": B * m_dn, "pixels": B * m_dn * px}
    assert sorted(counts["train.loss.masks"], key=lambda c: c["masks"]) == \
        sorted([matched] * L + [dn] * L, key=lambda c: c["masks"])
    assert all(isinstance(v, int) for c in counts["train.loss.masks"] for v in c.values())


def test_the_valid_share_of_the_mask_costs(seg):
    """Each mask cost's cells times the copy's valid GT rows over its own
    GT rows, over its cells: the valid share of the GT rows the mask costs
    run over, all of them, since they run over the valid rows alone."""
    costs = [s for s in seg.spans if s.name == "train.match.mask_costs"]
    (copy,) = [s for s in seg.spans if s.name == "train.match.copy"]
    valid = sum(s.counts["cells"] * copy.counts["valid_gt_rows"] / s.counts["gt_rows"]
                for s in costs)
    share = valid / sum(s.counts["cells"] for s in costs)
    assert share == 1.0


def test_an_eval_forward_records_the_head(seg):
    model = seg.state.model.eval()
    x = seg.batch["images"].permute(0, 3, 1, 2).float() / 255.0
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        out = model(x)
    (s,) = spans()
    clear_spans()
    assert out["pred_masks"].shape == (B, seg.cfg.decoder.num_queries, HM, HM)
    assert s.name == "model.mask_head" and s.parent is None
    assert s.counts == {"layers": 1, "rows": B * seg.cfg.decoder.num_queries,
                        "pixels": B * HM * HM}


def test_a_detect_step_records_no_mask_span(det):
    names = {s.name for s in det.spans}
    assert "train.match.costs" in names and "train.loss" in names
    assert names.isdisjoint(MASK_SPANS)
