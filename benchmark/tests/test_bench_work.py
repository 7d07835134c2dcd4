"""The yardstick's arithmetic against hand counts at tiny shapes."""

import math

import torch

from benchmark import work
from benchmark.harness import Check, result_line


def _one_level(loc_xy):
    value = torch.zeros(1, 16, 1, 2)                       # one 4x4 level, c = 2
    loc = torch.tensor(loc_xy, dtype=torch.float32).view(1, 1, 1, -1, 2)
    attn = torch.ones(1, 1, 1, loc.shape[3])
    return value, [(4, 4)], loc, attn, [loc.shape[3]]


def test_msda_rows_count_each_row_once():
    # a point at a pixel centre's corner: x = (1 + 0.5) / 4 -> corners x0 = 1, x1 = 2
    value, shapes, loc, attn, pts = _one_level([[1.5 / 4, 1.5 / 4], [1.5 / 4, 1.5 / 4]])
    rows, valid = work.msda_rows(value, shapes, loc, pts)
    assert (rows, valid) == (4, 8)  # two points on the same 4 rows
    value, shapes, loc, attn, pts = _one_level([[0.0, 0.0]])  # 3 of 4 corners outside
    assert work.msda_rows(value, shapes, loc, pts) == (1, 1)


def test_msda_work_by_hand():
    value, shapes, loc, attn, pts = _one_level([[1.5 / 4, 1.5 / 4], [3.0 / 4, 0.5]])
    rows, valid = work.msda_rows(value, shapes, loc, pts)
    b, f = work.msda_work(value, shapes, loc, attn, pts)
    c = 2
    assert b == rows * c * 4 + loc.numel() * 4 + attn.numel() * 4 + 1 * 1 * 1 * c * 4
    assert f == c * (2 * valid + 2 * attn.numel())
    b2, f2 = work.msda_bwd_work(value, shapes, loc, attn, pts)
    assert f2 == 12 * c * valid
    assert b2 == (rows * c * 4 + 2 * (loc.numel() * 4 + attn.numel() * 4) + c * 4
                  + value.numel() * 4)


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert work.bound_s(work.PEAK_BYTES, 1.0, work.PEAK_F32) == 1.0
    assert work.bound_s(1.0, work.PEAK_BF16 * 2, work.PEAK_BF16) == 2.0


def test_result_line_has_the_contract_keys():
    import json

    line = result_line(True, 10, 1, {"setup_s": {"value": 1.0, "unit": "s"}},
                       {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 5},
                       [Check("a", 0.1, 0.2), Check("b", math.nan, 1.0)])
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["checks"]["b"]["value"] is None and not Check("b", math.nan, 1.0).ok
