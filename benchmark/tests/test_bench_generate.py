"""The traffic pools: the same for one seed, different across seeds, with the
same sizes for every seed."""

import math

import pytest
import torch

from benchmark.generate import train_pool
from benchmark.harness import HERE, load_json

BIG = 2 ** 31 + 12345  # seeds run past 32 signed bits


def _train_mix():
    return dict(load_json(HERE / "traffic" / "train.json"), batch=4, img=64, pool=3)


def test_train_pool_repeats_per_seed_and_keeps_sizes_across_seeds():
    mix = _train_mix()
    a, b, c = (train_pool(mix, s, 80, "cpu") for s in (BIG, BIG, 7))
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert any(not torch.equal(x["images"], y["images"]) for x, y in zip(a, c))
    counts = lambda p: sorted(torch.cat([q["valid"].sum(1) for q in p]).tolist())  # noqa: E731
    assert counts(a) == counts(c)  # the same GT counts, in another order
    for batch in a:
        n = batch["valid"].sum(1)
        assert (n >= 1).all() and (n <= mix["max_gt"]).all()
        assert batch["images"].dtype == torch.uint8 and batch["images"].shape == (4, 64, 64, 3)
        v = batch["boxes"][batch["valid"]]
        assert ((v[:, :2] - v[:, 2:] / 2) >= -1e-6).all() and ((v[:, :2] + v[:, 2:] / 2) <= 1 + 1e-6).all()


def test_gt_counts_follow_the_mix():
    mix = dict(_train_mix(), pool=64, batch=16)
    pool = train_pool(mix, BIG, 80, "cpu")
    counts = torch.cat([q["valid"].sum(1) for q in pool]).float()
    assert abs(counts.mean().item() - mix["mean_gt"]) < 1.0
    boxes = torch.cat([q["boxes"][q["valid"]] for q in pool])
    side = (boxes[:, 2] * boxes[:, 3]).sqrt() * mix["img"]
    small = (side < 32).float().mean().item()
    assert abs(small - 0.41 / 0.99) < 0.03


def _mask_mix():
    return dict(_train_mix(), masks=True)


def test_masks_leave_every_other_tensor_as_it_was():
    """The masks take no draw: a mix with masks gives the tensors of the
    same mix without them, bit for bit."""
    plain = train_pool(_train_mix(), BIG, 80, "cpu")
    masked = train_pool(_mask_mix(), BIG, 80, "cpu", mask_size=16)
    for x, y in zip(plain, masked):
        assert set(y) == set(x) | {"masks"}
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_masks_repeat_per_seed_and_differ_across_seeds():
    a, b, c = (train_pool(_mask_mix(), s, 80, "cpu", mask_size=16) for s in (BIG, BIG, 7))
    assert all(torch.equal(x["masks"], y["masks"]) for x, y in zip(a, b))
    assert any(not torch.equal(x["masks"], y["masks"]) for x, y in zip(a, c))


def test_a_mix_with_masks_needs_the_mask_size():
    with pytest.raises(ValueError):
        train_pool(_mask_mix(), BIG, 80, "cpu")


def test_each_valid_gt_has_the_ellipse_inscribed_in_its_box():
    """uint8 {0,1} masks at the given size: zero in the padding rows; for
    each valid GT, pixels only inside its box, and in a box of 100 pixels or
    more about pi/4 of them (the inscribed ellipse)."""
    size = 160
    mix = dict(_train_mix(), img=640, batch=16, pool=2, masks=True)
    for batch in train_pool(mix, BIG, 80, "cpu", mask_size=size):
        m, v = batch["masks"], batch["valid"]
        assert m.dtype == torch.uint8 and m.shape == (16, mix["max_gt"], size, size)
        assert int(m.max()) == 1 and int(m[~v].sum()) == 0
        c = torch.arange(size, dtype=torch.float64) + 0.5
        for box, mask in zip(batch["boxes"][v].double() * size, m[v].bool()):
            cx, cy, w, h = box.tolist()
            in_box = ((c[None] - cx).abs() <= w / 2) & ((c[:, None] - cy).abs() <= h / 2)
            assert not (mask & ~in_box).any()
            n = int(in_box.sum())
            if n >= 100:
                assert abs(mask.sum().item() / n - math.pi / 4) < 0.1
