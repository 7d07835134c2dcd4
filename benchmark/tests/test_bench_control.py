"""The controls of `correct`, at a size a CPU test run holds: the next
precision below the configuration's, put in the program's place, must read
far above what the program reads on the same seed. On the chip they run at
the cells' own sizes (`python3 -m benchmark.control --mode control`)."""

import pytest

from benchmark.control import TrainControl
from benchmark.runners import train
from benchmark.run import limits_for

SEED = 2 ** 31 + 99


@pytest.mark.parametrize("precision", ["fp8", "int8"])
def test_train_control_reads_above_the_program(tiny, precision):
    cell = tiny("dfine-m.train")
    control = TrainControl(cell, SEED, "cpu")
    control.precision = precision
    runs = []
    for run in (train.make(cell, SEED, "cpu"), control):
        run.setup()
        run.release()
        run.check(limits_for(cell.name))
        runs.append(run.data["readings"])
    prog, ctrl = runs
    assert ctrl["stage1_gap.1"] >= 3 * max(prog["stage1_gap.1"], 1e-7), (prog, ctrl)
