"""custom_d_fine_tpu_torch/utils/profiling.py on the CPU: busy_ms on made-up
device spans (name, start_ns, duration_ns); the program's spans, which do
nothing without a profiler and under torch.profiler record their names,
parents, steps and counts on the profiler's clock; and the spans of one
training step of tests/helpers.py:tiny_config. The helpers that read the
card (device_spans, events_by_name) are held in tests/test_torch_cuda.py."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from custom_d_fine_tpu_torch.train import matcher
from custom_d_fine_tpu_torch.train import train_step as ttrain
from custom_d_fine_tpu_torch.utils import profiling
from custom_d_fine_tpu_torch.utils.profiling import busy_ms, clear_spans, span, spans

from helpers import tiny_config
from torch_jax_models import port_config

SPANS = [("a", 0, 1_000_000), ("b", 500_000, 1_000_000),  # overlap: 1.5 ms busy
         ("a", 3_000_000, 2_000_000),                       # gap, then 2 ms
         ("c", 3_500_000, 500_000)]                         # inside the last one


@pytest.mark.parametrize("spans,want", [(SPANS, 3.5), (SPANS[::-1], 3.5), ([], 0.0),
                                        ([("x", 10, 0)], 0.0)])
def test_busy_ms_is_the_union_of_intervals(spans, want):
    assert busy_ms(spans) == pytest.approx(want)


def test_a_span_records_nothing_without_a_profiler():
    clear_spans()
    with span("outer", images=2) as outer:
        with span("inner") as inner:
            inner.count(bytes=3)
    assert outer is inner is profiling._OFF
    assert spans() == []


def test_nested_spans_record_name_parent_step_and_counts():
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", images=2):
            with span("inner", bytes=1) as inner:
                inner.count(bytes=4, cells=3)
                inner.count(cells=2)
        with span("next"):
            pass
    assert [s.name for s in spans()] == ["inner", "outer", "next"]
    inner, outer, nxt = spans()
    assert outer.parent is None and outer.step == outer.seq
    assert inner.parent == outer.seq and inner.step == outer.seq
    assert nxt.parent is None and nxt.step == nxt.seq != outer.seq
    assert outer.counts == {"images": 2} and inner.counts == {"bytes": 5, "cells": 5}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= nxt.start_ns
    annotations = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"outer", "inner", "next"} <= annotations  # record_function, for exported traces
    clear_spans()
    assert spans() == []


def test_spans_share_the_profilers_clock():
    """The aten ops run inside a span lie within its bounds, and those run
    2 ms before and after it outside them, to 0.1 ms."""
    clear_spans()
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.add(a, 1)
        time.sleep(0.002)
        with span("inside"):
            for _ in range(5):
                torch.mm(a, a)
        time.sleep(0.002)
        torch.add(a, 1)
    (s,) = spans()
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    inside = [o for o in ops if o[0] == "aten::mm"]
    outside = [o for o in ops if o[0] == "aten::add"]
    assert len(inside) == 5 and len(outside) >= 2
    tol = 100_000
    for _, t0, t1 in inside:
        assert s.start_ns - tol <= t0 <= t1 <= s.end_ns + tol
    for _, t0, t1 in outside:
        assert t1 <= s.start_ns + tol or t0 >= s.end_ns - tol


IMG, B, NC = 160, 2, 4
STEP_SPANS = {"train.step": None, "train.forward": "train.step", "train.loss": "train.step",
              "train.match": "train.loss", "train.match.costs": "train.match",
              "train.match.copy": "train.match", "train.match.solve": "train.match",
              "train.match.upload": "train.match", "train.backward": "train.step",
              "train.optimizer": "train.step", "train.ema": "train.step"}


@pytest.fixture(scope="module")
def one_step():
    """One CPU step of build_training (tiny_config, 160^2, batch 2, f32)
    under torch.profiler, with what the matcher handed its solve."""
    cfg = port_config(tiny_config())
    step, state = ttrain.build_training(cfg, NC, device="cpu", bf16=False, seed=0)
    rng = np.random.default_rng(0)
    G = cfg.max_gt
    n_valid = np.array([3, 5])
    valid = np.arange(G)[None] < n_valid[:, None]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)), rng.uniform(0.1, 0.2, (B, G, 2))], -1)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, NC, (B, G))),
             "boxes": torch.from_numpy(boxes.astype(np.float32)),
             "valid": torch.from_numpy(valid)}
    solved = []
    solve = matcher.host_solve

    def recorded(costs, valid):
        solved.append((costs.shape, costs.nbytes + valid.nbytes))
        return solve(costs, valid)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matcher, "host_solve", recorded)
        clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            step(state, batch, torch.Generator().manual_seed(0))
    out = SimpleNamespace(spans=spans(), solved=solved, n_valid=n_valid, cfg=cfg)
    clear_spans()
    return out


@pytest.mark.parametrize("name", list(STEP_SPANS))
def test_a_training_step_records_each_span_once(one_step, name):
    """Each span of the step once, inside its parent, in the root's step."""
    (s,) = [x for x in one_step.spans if x.name == name]
    by_seq = {x.seq: x for x in one_step.spans}
    assert by_seq[s.step].name == "train.step"
    if STEP_SPANS[name] is None:
        assert s.parent is None and s.counts == {"images": B}
    else:
        parent = by_seq[s.parent]
        assert parent.name == STEP_SPANS[name]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_a_training_steps_counts(one_step):
    """The matcher's counts: the copy's bytes are the packed costs' (each
    image's valid GT columns only) and the valid mask's that the solve
    received, and every cell copied is a valid one."""
    assert len(one_step.spans) == len(STEP_SPANS)
    by_name = {s.name: s for s in one_step.spans}
    (shape, nbytes), = one_step.solved
    S, Q, G = one_step.cfg.decoder.num_layers + 2, one_step.cfg.decoder.num_queries, \
        one_step.cfg.max_gt
    n = int(one_step.n_valid.sum())
    assert shape == (S, Q * n)
    assert by_name["train.match.copy"].counts == {
        "bytes": nbytes, "cells": S * Q * n, "valid_cells": S * Q * n, "valid_gt_rows": n}
    assert nbytes == S * Q * n * 4 + B * G
    assert by_name["train.match.solve"].counts == {"solves": S * B}
    assert by_name["train.match.upload"].counts == {"bytes": S * B * G * 8 + B * Q * 9}


def test_the_forward_counts_no_graph_units_on_the_cpu(one_step):
    """train.forward counts the units replayed as CUDA graphs, those run
    eagerly in a step that would graph them, and the captures
    (train/graphs.py): none in a CPU step, which never graphs."""
    (fwd,) = [s for s in one_step.spans if s.name == "train.forward"]
    assert fwd.counts == {"graph_units": 0, "eager_units": 0, "captures": 0}
