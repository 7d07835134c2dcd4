"""CPU tests of the benchmark. Run from the checkout's root:

    python -m pytest benchmark/tests -q

Runs here use the registry's smallest model ("n") at 320x320 on the CPU,
where the port takes its kernels' plain versions."""

import pytest

from benchmark.harness import find_cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def tiny_seg():
    return tiny_segment_cell


def tiny_cell(name: str):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds."""
    cell = find_cell(name)
    cell.config = dict(cell.config, model_name="n", img_size=[320, 320])
    cell.traffic = dict(cell.traffic, batch=2, img=320, pool=5, bf16=False,
                        warmup_steps=1, trace_steps=1)
    return cell


def tiny_segment_cell():
    """A segment cell that BENCHMARK.json does not list: dfine-m.train's
    configuration with task segment and its traffic with masks, cut as
    tiny_cell cuts (masks at 40 x 40, twice D-FINE-n's finest level)."""
    cell = tiny_cell("dfine-m.train")
    cell.name, cell.config_name, cell.traffic_name = ("tiny-seg.train-masks", "tiny-seg",
                                                       "train-masks")
    cell.config = dict(cell.config, task="segment")
    cell.traffic = dict(cell.traffic, masks=True)
    return cell
