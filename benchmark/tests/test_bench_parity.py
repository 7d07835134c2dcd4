"""The reference (benchmark/reference) against the port on the CPU at one
small size (D-FINE-n, 320x320), from the same weights: the forward, and one
training step's losses and update. The test imports both; the
reference imports nothing of the port."""

import torch

from benchmark.runners.common import model_config
from benchmark.generate import train_pool
from benchmark.harness import HERE, load_json
from benchmark.reference.dfine.models.dfine import DFINE
from benchmark.reference.dfine.train.criterion import DFINECriterion
from benchmark.reference.dfine.train.optim import Optimizer
from benchmark.reference.dfine.train.train_step import RefState, train_step
from benchmark.weights import make_weights

CONFIG = {"model_name": "n", "task": "detect", "num_classes": 80, "img_size": [320, 320]}


def _weights(seed=3):
    return make_weights(model_config(CONFIG), 80, seed, torch.device("cpu"))


def _ref_model(w):
    m = DFINE(model_config(CONFIG), num_classes=80)
    m.load_state_dict(w)
    return m


def test_forward_matches_the_port():
    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.models.dfine import DFINE as PortDFINE

    w = _weights()
    port = PortDFINE(get_model_config("n"), num_classes=80)
    port.load_state_dict(w)
    x = torch.rand((2, 3, 320, 320), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = port.eval()(x), _ref_model(w).eval()(x)
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)


def test_one_training_step_matches_the_port():
    from custom_d_fine_tpu_torch.train.train_step import build_training

    mix = dict(load_json(HERE / "traffic" / "train.json"), batch=2, img=320, pool=1)
    batch = train_pool(mix, 5, 80, "cpu")[0]
    w = _weights()
    opt = {k: mix[k] for k in ("base_lr", "backbone_lr", "total_steps")}
    step, state = build_training("n", 80, device="cpu", bf16=False, state_dict=w, **opt)
    _, got = step(state, batch, torch.Generator().manual_seed(9))

    cfg = model_config(CONFIG)
    model = _ref_model(w).train()
    ref = RefState(model, Optimizer(model, cfg, **opt),
                   {k: v.clone() for k, v in model.state_dict().items()})
    want = train_step(ref, DFINECriterion(cfg.criterion, cfg.matcher, 80), batch,
                      torch.Generator().manual_seed(9))
    assert set(got) == set(want)
    for k in want:
        # grad_norm: the pre-clip norm sums the backbone's LAB and BatchNorm
        # scalars, whose gradients are sums with cancellation; the port's
        # channels_last convolutions and written-out MSDA backward and the
        # reference's autograd through the gather round them differently
        # (3e-4 here; the repo's own slice tests hold it at 6e-3)
        rtol = 2e-3 if k == "grad_norm" else 1e-4
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=1e-6, msg=k)
    # the update: AdamW's first step moves each element by about lr x sign(g),
    # so the parameters agree to a share of one step
    for (k, p), q in zip(state.model.named_parameters(), model.parameters()):
        lr = 2 * opt["base_lr"]
        assert (p.detach() - q.detach()).abs().max() <= lr, k
