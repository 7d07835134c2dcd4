"""metrics/graph.replay_share.train.py on made-up spans: the units replayed
as CUDA graphs over all the units counted on the `train.forward` spans of
the traced window's steps; nothing without such counts (a program that
graphs nothing, or has no spans)."""

import pytest

from benchmark import spans as sp
from benchmark.harness import Profile, load_reader
from custom_d_fine_tpu_torch.utils.profiling import Span


def step(root: int, t0: int, **counts):
    return [Span("train.step", t0, t0 + 100, root, None, root, {"images": 2}),
            Span("train.forward", t0, t0 + 40, root + 1, root, root, counts),
            Span("train.loss", t0 + 40, t0 + 80, root + 2, root, root, {})]


def read(monkeypatch, spans, t0=0):
    monkeypatch.setattr(sp, "program_spans", lambda: spans)
    prof = Profile(window_s=1.0, device=[("k", t0 + 10, 50)], host=[("aten::x", t0, 300)],
                   units=1)
    return load_reader("graph.replay_share.train")({"profile": prof})


def test_share_of_units_replayed(monkeypatch):
    spans = (step(0, 0, graph_units=6, eager_units=0, captures=6)
             + step(10, 110, graph_units=5, eager_units=1, captures=0)
             + step(20, 220, graph_units=6, eager_units=0, captures=0))
    assert read(monkeypatch, spans) == pytest.approx(100.0 * 17 / 18)


def test_steps_outside_the_window_are_ignored(monkeypatch):
    spans = step(0, 0, graph_units=6, eager_units=0) + step(10, 10_000, eager_units=6)
    assert read(monkeypatch, spans) == pytest.approx(100.0)


@pytest.mark.parametrize("counts", [{}, {"graph_units": 0, "eager_units": 0, "captures": 0}])
def test_nothing_counted_gives_nothing(monkeypatch, counts):
    assert read(monkeypatch, step(0, 0, **counts)) is None


def test_no_spans_give_nothing(monkeypatch):
    assert read(monkeypatch, []) is None
