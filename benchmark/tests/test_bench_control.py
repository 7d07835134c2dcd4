"""The controls of `correct`, at a size a CPU test run holds: the next
precision below the configuration's, put in the program's place, must read
far above what the program reads on the same seed. On the chip they run at
the cells' own sizes (`python3 -m benchmark.control --mode control`)."""

import pytest
import torch
from torch import nn

from benchmark.control import TrainControl
from benchmark.lowp import Fp8Compute, Int8Compute, fp8_round, int8_round, round_leaf_outputs
from benchmark.reference.dfine.models.layers import MLP
from benchmark.reference.dfine.models.mask import GroupNorm, MaskDecoder, mask_logits
from benchmark.runners import train
from benchmark.run import limits_for

SEED = 2 ** 31 + 99


def _readings(cell, precision, limits):
    control = TrainControl(cell, SEED, "cpu")
    control.precision = precision
    runs = []
    for run in (train.make(cell, SEED, "cpu"), control):
        run.setup()
        run.release()
        run.check(limits)
        runs.append(run.data["readings"])
    return runs


@pytest.mark.parametrize("precision", ["fp8", "int8"])
def test_train_control_reads_above_the_program(tiny, precision):
    cell = tiny("dfine-m.train")
    prog, ctrl = _readings(cell, precision, limits_for(cell.name))
    assert ctrl["stage1_gap.1"] >= 3 * max(prog["stage1_gap.1"], 1e-7), (prog, ctrl)


@pytest.mark.parametrize("precision", ["fp8", "int8"])
def test_segment_control_reads_above_the_program(tiny_seg, precision):
    prog, ctrl = _readings(tiny_seg(), precision, {})
    for k in ("stage1_gap.1", "mask_feat_gap.1", "mask_feat_local_gap.1", "mask_gap.1"):
        assert ctrl[k] >= 3 * max(prog[k], 1e-7), (k, prog, ctrl)


@pytest.mark.parametrize("mode,rnd", [(Fp8Compute, fp8_round), (Int8Compute, int8_round)],
                         ids=["fp8", "int8"])
def test_the_controls_round_the_mask_head_itself(mode, rnd):
    """From the same inputs, the mask decoder and the mask head under the
    control differ from f32 by their own rounding: the hooks reach every conv
    and GroupNorm, the mode every conv, linear map and the matmul."""
    g = torch.Generator().manual_seed(0)
    dec, head = MaskDecoder([128, 128], 256), MLP(128, 128, 256, 3)
    feats = [torch.randn((1, 128, 8, 8), generator=g), torch.randn((1, 128, 4, 4), generator=g)]
    q = torch.randn((1, 10, 128), generator=g)
    with torch.no_grad():
        exact = mask_logits(head, 256, q, dec(feats))
        handles = round_leaf_outputs(dec, rnd) + round_leaf_outputs(head, rnd)
        with mode():
            low = mask_logits(head, 256, q, dec(feats))
    leaves = [m for m in list(dec.modules()) + list(head.modules()) if not list(m.children())]
    assert len(handles) == len(leaves) == 11  # 4 convs, 4 GroupNorms, 3 linear maps
    assert sum(isinstance(m, (nn.Conv2d, GroupNorm)) for m in leaves) == 8
    gap = float((low - exact).norm() / exact.norm())
    assert gap > 3e-3, gap
