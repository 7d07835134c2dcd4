"""Each run's check on the CPU at a tiny size: a sound run comes out correct;
with the timed path broken underneath (faults.py) it comes out not correct,
once for each fault that the cell can have. The look for a card is skipped:
the runner runs on the CPU with the port's plain kernels.

The numbers compared are the cell's own; the limits are scaled to the tiny
model, whose f32 run on the CPU agrees with the reference to ~1e-5 (the
cell's limits allow for the bf16 paths on the card)."""

import pytest

from benchmark.faults import STEP_FAULTS
from benchmark.runners import train

TINY_LIMITS = {"stage1_gap.1": 1e-3, "matching_excess": 0.05, "selection_excess": 0.01,
               "choices_mismatched": 0.0, "dn_loss_gap.1": 1e-3, "change_gap": 0.1}

SEED = 2 ** 31 + 77


def _train(tiny, **kw):
    run = train.make(tiny("dfine-m.train"), SEED, "cpu", **kw)
    run.setup()
    res = run.window(0.1)
    run.release()
    return res, run.check(TINY_LIMITS)


def test_train_sound(tiny):
    res, checks = _train(tiny)
    assert res["failed"] == 0 and all(c.ok for c in checks), checks


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
def test_train_fault_is_not_correct(tiny, fault):
    _, checks = _train(tiny, step_wrapper=STEP_FAULTS[fault])
    assert not all(c.ok for c in checks), (fault, checks)
