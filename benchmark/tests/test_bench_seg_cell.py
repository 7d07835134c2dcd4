"""The segment cell `dfine-m-seg.train`: its two readers on made-up spans
and device intervals with known idle time and counts (metrics/
idle.mask.seg.train.py, mask.cost_useful.seg.train.py), nothing from a
program without the mask spans, and its files: the limits hold detect's six
as they are and the three mask readings, and the traffic is `train` with
masks."""

import pytest

from benchmark import spans as sp
from benchmark.harness import HERE, Profile, find_cell, load_json, load_reader
from custom_d_fine_tpu_torch.utils.profiling import Span

CELL = "dfine-m-seg.train"
NEW = ("idle.mask.seg.train", "mask.cost_useful.seg.train")
MASKS = ("mask_loss_gap.1", "dn_mask_loss_gap.1", "mask_feat_local_gap.1")


def step(root, t0, masks=True, valid=(3, 3), copy_rows=16):
    """One step's spans from t0 to t0 + 1000 ns: the head inside the
    forward, one mask cost inside the costs, the matcher's copy, two crops
    inside the loss. `valid`: the batch's valid GT, out of 8 padded rows of
    2 images (the mask cost's cells 2 x Q x 8 x px with Q x px = 10); the
    copy runs over `copy_rows` GT rows."""
    def s(i, name, a, b, parent, **counts):
        return Span(name, t0 + a, t0 + b, root + i, parent, root, counts)

    out = [s(0, "train.step", 0, 1000, None, images=2),
           s(1, "train.forward", 0, 400, root),
           s(3, "train.loss", 400, 900, root),
           s(4, "train.match", 450, 600, root + 3),
           s(5, "train.match.costs", 450, 500, root + 4),
           s(9, "train.match.copy", 500, 520, root + 4, cells=4 * copy_rows,
             valid_cells=4 * sum(valid), valid_gt_rows=sum(valid))]
    if masks:
        out += [s(2, "model.mask_head", 300, 400, root + 1, layers=4, rows=8, pixels=2),
                s(6, "train.match.mask_costs", 460, 480, root + 5, sets=1, cells=2 * 10 * 8,
                  gt_rows=2 * 8),
                s(7, "train.loss.masks", 700, 750, root + 3, masks=16, pixels=4),
                s(8, "train.loss.masks", 800, 850, root + 3, masks=16, pixels=4)]
    return out


# device busy over a step at 0: idle [100, 320) [350, 470) [475, 720) [740, 950) = 795 ns;
# of it inside the mask spans: 20 + 50 (head) + 10 + 5 (costs) + 20 + 10 + 50 (crops) = 165
BUSY = [(0, 100), (320, 30), (470, 5), (720, 20), (950, 50)]


def profile(t0=0, busy=BUSY):
    return Profile(window_s=1.0, device=[("k", t0 + a, d) for a, d in busy],
                   host=[("aten::x", t0, 1000)], units=1)


def read(monkeypatch, name, spans, data):
    monkeypatch.setattr(sp, "program_spans", lambda: spans)
    return load_reader(name)(data)


def test_idle_inside_the_mask_spans(monkeypatch):
    got = read(monkeypatch, "idle.mask.seg.train", step(0, 0), {"profile": profile()})
    assert got == pytest.approx(100.0 * 165 / 795)


def test_idle_over_two_steps_and_none_outside_the_window(monkeypatch):
    """Two steps in the window read as the sum of their idle times; a step
    outside it is left out."""
    spans = step(0, 0) + step(10, 1000) + step(20, 50_000)
    prof = profile(busy=BUSY + [(1000 + a, d) for a, d in BUSY])
    prof.host = [("aten::x", 0, 2000)]
    assert read(monkeypatch, "idle.mask.seg.train", spans, {"profile": prof}) == \
        pytest.approx(100.0 * 330 / 1590)


def test_a_device_busy_through_the_mask_spans_reads_zero(monkeypatch):
    busy = [(0, 100), (300, 100), (460, 20), (700, 50), (800, 50)]
    assert read(monkeypatch, "idle.mask.seg.train", step(0, 0),
                {"profile": profile(busy=busy)}) == 0.0


@pytest.mark.parametrize("copy_rows", [16, 6], ids=["padded-copy", "packed-copy"])
def test_the_valid_share_of_the_mask_costs(monkeypatch, copy_rows):
    """The copy's valid GT rows over the mask costs' own padded rows: here
    (3 + 3 + 1 + 4) valid of 2 x 8 padded rows in each of two steps, the
    same whichever rows the copy runs over."""
    spans = step(0, 0, valid=(3, 3), copy_rows=copy_rows) + \
        step(10, 1000, valid=(1, 4), copy_rows=copy_rows)
    prof = profile()
    prof.host = [("aten::x", 0, 2000)]
    got = read(monkeypatch, "mask.cost_useful.seg.train", spans, {"profile": prof})
    assert got == pytest.approx(100.0 * 11 / 32)


def test_mask_costs_without_the_copys_rows_give_nothing(monkeypatch):
    """A program whose copy does not count the valid GT rows reads nothing."""
    spans = step(0, 0)
    spans = [s._replace(counts={k: v for k, v in s.counts.items() if k != "valid_gt_rows"})
             for s in spans]
    assert read(monkeypatch, "mask.cost_useful.seg.train", spans, {"profile": profile()}) is None


@pytest.mark.parametrize("name", ["idle.mask.seg.train", "mask.cost_useful.seg.train"])
@pytest.mark.parametrize("spans", [[], step(0, 0, masks=False)], ids=["no-spans", "detect"])
def test_no_mask_span_gives_nothing(monkeypatch, name, spans):
    assert read(monkeypatch, name, spans, {"profile": profile()}) is None


@pytest.mark.parametrize("name", ["idle.mask.seg.train", "mask.cost_useful.seg.train"])
def test_no_profile_gives_nothing(monkeypatch, name):
    assert read(monkeypatch, name, step(0, 0), {}) is None


def test_the_cells_limits_are_detects_and_the_masks():
    detect = load_json(HERE / "limits" / "dfine-m.train.json")["limits"]
    seg = load_json(HERE / "limits" / f"{CELL}.json")
    assert set(seg["limits"]) == set(detect) | set(MASKS) == set(seg["set_from"])
    assert {k: seg["limits"][k] for k in detect} == detect
    assert {k: seg["limits"][k] for k in MASKS} == {"mask_loss_gap.1": 0.03,
                                                   "dn_mask_loss_gap.1": 0.03,
                                                   "mask_feat_local_gap.1": 0.02}


def test_the_cell_is_train_with_masks_and_reports_the_new_metrics():
    cell = find_cell(CELL)
    train = load_json(HERE / "traffic" / "train.json")
    assert cell.config["task"] == "segment" and cell.traffic["masks"] is True
    assert {k: v for k, v in cell.traffic.items() if k not in ("about", "masks")} == \
        {k: v for k, v in train.items() if k != "about"}
    # the cell's two metrics, then the criterion's graph share, which
    # BENCHMARK.json gives both cells
    assert [m["name"] for m in cell.per_layer] == [*NEW, "loss.graph_share.train"]
