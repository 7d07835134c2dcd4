"""CPU tests of the benchmark. Run from the checkout's root:

    python -m pytest benchmark/tests -q

Runs here use the registry's smallest model ("n") at 320x320 on the CPU,
where the port takes its kernels' plain versions."""

import pytest

from benchmark.harness import find_cell


@pytest.fixture
def tiny():
    return tiny_cell


def tiny_cell(name: str):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds."""
    cell = find_cell(name)
    cell.config = dict(cell.config, model_name="n", img_size=[320, 320])
    cell.traffic = dict(cell.traffic, batch=2, img=320, pool=5, bf16=False,
                        warmup_steps=1, trace_steps=1)
    return cell
