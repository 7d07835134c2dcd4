"""Each run's check on the CPU at a tiny size: a sound run comes out correct;
with the timed path broken underneath (faults.py) it comes out not correct,
once for each fault that the cell can have. The look for a card is skipped:
the runner runs on the CPU with the port's plain kernels.

The numbers compared are the cell's own; the limits are scaled to the tiny
model, whose f32 run on the CPU agrees with the reference to ~1e-5 (the
cell's limits allow for the bf16 paths on the card)."""

import pytest

from benchmark.faults import DETECT_FAULTS, STEP_FAULTS, wrong_masks
from benchmark.runners import train

TINY_LIMITS = {"stage1_gap.1": 1e-3, "matching_excess": 0.05, "selection_excess": 0.01,
               "choices_mismatched": 0.0, "dn_loss_gap.1": 1e-3, "change_gap": 0.1}

SEED = 2 ** 31 + 77


# a segment cell compares its mask loss gaps too
TINY_SEG_LIMITS = dict(TINY_LIMITS, **{"mask_loss_gap.1": 1e-3, "dn_mask_loss_gap.1": 1e-3})


def _train(tiny, cell="dfine-m.train", **kw):
    seg = not isinstance(cell, str)
    run = train.make(cell if seg else tiny(cell), SEED, "cpu", **kw)
    run.setup()
    res = run.window(0.1)
    run.release()
    return res, run.check(TINY_SEG_LIMITS if seg else TINY_LIMITS), run.data["readings"]


def test_train_sound(tiny):
    res, checks, _ = _train(tiny)
    assert res["failed"] == 0 and all(c.ok for c in checks), checks


@pytest.mark.parametrize("fault", sorted(DETECT_FAULTS))
def test_train_fault_is_not_correct(tiny, fault):
    _, checks, _ = _train(tiny, step_wrapper=DETECT_FAULTS[fault])
    assert not all(c.ok for c in checks), (fault, checks)


def test_segment_cell_runs_end_to_end(tiny, tiny_seg):
    """A segment cell that BENCHMARK.json does not list: set-up, window and
    check, with the mask readings, and correct under the tiny limits."""
    res, checks, readings = _train(tiny, tiny_seg())
    assert res["failed"] == 0 and res["attempted"] >= 1 and all(c.ok for c in checks), checks
    for k in ("mask_feat_gap.1", "mask_feat_local_gap.1", "mask_gap.1", "mask_loss_gap.1",
              "dn_mask_loss_gap.1"):
        assert readings[k] < 1e-3, (k, readings)


def test_detect_cell_reads_no_mask_numbers(tiny):
    _, _, readings = _train(tiny)
    assert not [k for k in readings if "mask" in k]


def test_wrong_masks_reads_far_above_the_sound_run(tiny, tiny_seg):
    _, _, sound = _train(tiny, tiny_seg())
    _, _, fault = _train(tiny, tiny_seg(), step_wrapper=wrong_masks)
    k = "mask_loss_gap.1"
    assert fault[k] >= 5 * max(sound[k], 1e-7), (sound[k], fault[k])


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
def test_segment_fault_is_not_correct(tiny, tiny_seg, fault):
    _, checks, _ = _train(tiny, tiny_seg(), step_wrapper=STEP_FAULTS[fault])
    assert not all(c.ok for c in checks), (fault, checks)
