"""The arithmetic of benchmark/spans.py on made-up device intervals and
spans: the innermost phase takes an idle instant, the shares and the
uncovered remainder sum to 100, spans outside the profile's window are
ignored, and no spans give nothing."""

import pytest

from benchmark import spans as sp
from benchmark.harness import Profile
from custom_d_fine_tpu_torch.utils.profiling import Span


def step(root: int, t0: int):
    """One step at t0: forward [0, 40), loss [40, 80) holding match [50, 70)
    with its copy [52, 60), backward [80, 90), optimizer [90, 95), ema
    [95, 100); the step [0, 105) leaves [100, 105) to no phase."""
    def s(i, name, a, b, parent, **counts):
        return Span(name, t0 + a, t0 + b, root + i, parent, root, counts)

    return [s(0, "train.step", 0, 105, None, images=2),
            s(1, "train.forward", 0, 40, root),
            s(2, "train.loss", 40, 80, root),
            s(3, "train.match", 50, 70, root + 2),
            s(4, "train.match.copy", 52, 60, root + 3, cells=100, valid_cells=8),
            s(5, "train.match.solve", 60, 66, root + 3, solves=4),
            s(6, "train.backward", 80, 90, root),
            s(7, "train.optimizer", 90, 95, root),
            s(8, "train.ema", 95, 100, root)]


def profile(t0: int, device) -> Profile:
    return Profile(window_s=1.0, device=[("k", t0 + a, d) for a, d in device],
                   host=[("aten::x", t0, 110)], units=1)


# busy [0, 30), [45, 55), [75, 92), [98, 104): idle [30, 45) forward 10 loss 5,
# [55, 75) match 15 loss 5, [92, 98) update 6, [104, 105) uncovered 1
BUSY = [(0, 30), (45, 10), (75, 17), (98, 6)]
IDLE = {"forward": 10, "loss": 10, "match": 15, "backward": 0, "update": 6, "uncovered": 1}


def test_innermost_phase_takes_the_idle_instant():
    ns = sp.idle_ns(profile(0, BUSY), step(0, 0))
    assert ns == dict(IDLE, idle=42)


def test_shares_and_remainder_sum_to_100():
    shares = sp.idle_shares(profile(0, BUSY), step(0, 0))
    assert shares == pytest.approx({k: 100.0 * v / 42 for k, v in IDLE.items()})
    assert sum(shares.values()) == pytest.approx(100.0)


def test_spans_outside_the_window_are_ignored():
    spans = step(0, 0) + step(100, 10_000)  # a step of another profiled window
    prof = profile(10_000, BUSY)
    assert list(sp.window_steps(prof, spans)) == [100]
    assert sp.idle_ns(prof, spans) == dict(IDLE, idle=42)
    assert sp.solve_ms(prof, spans) == pytest.approx(6 / 1e6)
    assert sp.copy_useful(prof, spans) == pytest.approx(8.0)


@pytest.mark.parametrize("read", [sp.idle_shares, sp.idle_ns, sp.solve_ms, sp.copy_useful])
@pytest.mark.parametrize("case", ["no spans", "no profile", "spans elsewhere"])
def test_no_spans_give_nothing(read, case):
    spans, prof = {"no spans": ([], profile(0, BUSY)), "no profile": (step(0, 0), None),
                   "spans elsewhere": (step(0, 10_000), profile(0, BUSY))}[case]
    assert read(prof, spans) is None


def test_no_idle_time_gives_no_shares():
    assert sp.idle_shares(profile(0, [(0, 105)]), step(0, 0)) is None


@pytest.mark.parametrize("holes,want", [([], [(0, 10)]), ([(2, 4), (6, 8)], [(0, 2), (4, 6), (8, 10)]),
                                        ([(-5, 3), (9, 20)], [(3, 9)]), ([(-5, 20)], [])])
def test_subtract(holes, want):
    assert sp.subtract((0, 10), holes) == want
