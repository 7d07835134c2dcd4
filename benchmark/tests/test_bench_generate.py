"""The traffic pools: the same for one seed, different across seeds, with the
same sizes for every seed."""

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
