"""The seeded weights of a configuration with frozen backbone norms (D-FINE-x,
at 160x160 on the CPU): every frozen norm normalises the calibration batch,
the backbone's outputs keep a std near 1 where the statistics at their
init, (0, 1), leave them ~10^2 and more; the draws are those of the weights
without the calibration; the same seed gives the same tensors. And the
reference's step counts one MSDA call each way per decoder layer."""

import pytest
import torch

from benchmark import weights
from benchmark.reference.dfine.models.dfine import DFINE
from benchmark.reference.dfine.models.layers import BatchNorm
from benchmark.runners.common import model_config
from benchmark.weights import calibration_images, make_weights

X = {"model_name": "x", "task": "detect", "num_classes": 80}
IMG, SEED = 160, 2 ** 31 + 11
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def x_weights():
    return make_weights(model_config(X), 80, SEED, CPU, IMG)


def _backbone(w, train=True):
    model = DFINE(model_config(X), num_classes=80)
    model.load_state_dict(w)
    return model.backbone.train(train)


def _frozen_running_stats(w):
    return [k for k in w if k.startswith("backbone.") and k.endswith(("running_mean",
                                                                      "running_var"))]


def test_frozen_norms_normalise_the_calibration_batch(x_weights):
    """In train mode (the frozen norms use their running statistics), each
    frozen norm's output over the calibration batch has per-channel mean
    within 0.05 of 0 and variance within 0.1 of 1, and the backbone's three
    outputs a std within [0.25, 4]."""
    backbone = _backbone(x_weights)
    norms = [m for m in backbone.modules() if isinstance(m, BatchNorm)]
    assert norms and all(m.frozen for m in norms)
    outs = []
    handles = [m.register_forward_hook(lambda _m, _i, o: outs.append(o)) for m in norms]
    with torch.no_grad():
        feats = backbone(calibration_images(SEED, IMG, CPU))
    for h in handles:
        h.remove()
    assert len(outs) == len(norms)
    for o in outs:
        assert o.mean((0, 2, 3)).abs().max() < 0.05
        assert (o.var((0, 2, 3), unbiased=False) - 1).abs().max() < 0.1
    stds = [f.std().item() for f in feats]
    assert len(stds) == 3 and all(0.25 <= s <= 4 for s in stds), stds


def test_without_the_statistics_the_front_is_not_normalised(x_weights):
    """The same weights with every frozen norm at its init, (0, 1): the
    deepest output's std is far past 4 (~500 here, 4,260 at 256^2)."""
    w = dict(x_weights)
    for k in _frozen_running_stats(w):
        w[k] = torch.zeros_like(w[k]) if k.endswith("mean") else torch.ones_like(w[k])
    with torch.no_grad():
        feats = _backbone(w)(calibration_images(SEED, IMG, CPU))
    assert feats[-1].std().item() > 40


def test_the_draws_are_those_without_the_calibration(x_weights, monkeypatch):
    """The calibration draws nothing from the weights' generator and writes
    nothing but the frozen norms' running statistics: every other tensor is
    the one made without it, and the batch counts stay at 0."""
    monkeypatch.setattr(weights, "_calibrate_frozen_norms", lambda *a: None)
    plain = make_weights(model_config(X), 80, SEED, CPU, IMG)
    stats = set(_frozen_running_stats(plain))
    assert stats and plain.keys() == x_weights.keys()
    assert all(torch.equal(plain[k], x_weights[k]) for k in plain if k not in stats)
    assert not any(torch.equal(plain[k], x_weights[k]) for k in stats)
    counts = [v for k, v in x_weights.items() if k.endswith("num_batches_tracked")]
    assert counts and all(int(c) == 0 for c in counts)


def test_the_same_seed_gives_the_same_statistics(x_weights):
    again = make_weights(model_config(X), 80, SEED, CPU, IMG)
    assert all(torch.equal(again[k], x_weights[k]) for k in x_weights)


def test_frozen_norms_need_the_image_size():
    with pytest.raises(ValueError, match="img"):
        make_weights(model_config(X), 80, SEED, CPU)


def test_norms_that_are_not_frozen_take_no_calibration():
    """D-FINE-n trains its norms: the image size changes nothing."""
    cfg = model_config(dict(X, model_name="n"))
    a, b = make_weights(cfg, 80, 5, CPU), make_weights(cfg, 80, 5, CPU, IMG)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("size,layers", [("n", 3), ("m", 4), ("x", 6)])
def test_the_counted_step_prices_one_msda_call_per_decoder_layer(monkeypatch, size, layers):
    """`_counted_step` multiplies the captured first MSDA call's work, each
    way, by the decoder's num_layers."""
    from types import SimpleNamespace

    from benchmark.runners import train

    monkeypatch.setattr(train, "train_step", lambda *a: {})  # no FLOPs of its own
    cell = SimpleNamespace(traffic={"img": 64}, config=dict(X, model_name=size))
    run = train.Train(cell, 1, "cpu")
    assert model_config(run.config).decoder.num_layers == layers
    run.data["kernels"] = {"msda_fwd": {"flops": 1.0}, "msda_bwd": {"flops": 2.0}}
    run._counted_step(None, None, None, None)
    assert run.data["flops"]["msda"] == layers * 3.0
    assert run.data["least_s"] == pytest.approx(layers * 3.0 / train.work.PEAK_F32)
