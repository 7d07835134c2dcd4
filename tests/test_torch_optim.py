"""The port's optimizer and EMA (custom_d_fine_tpu_torch/train/optim.py,
train/ema.py) against the JAX package's (train/optim.py, train/ema.py) on
equal inputs:
  - the parameter groups of label_params, parameter by parameter through the
    name bridge (utils/weights.py:flax_to_torch);
  - the OneCycle schedule against optax's, with the guard for tiny runs;
  - the whole transformation (global-norm clipping at 0.1, 4-group AdamW,
    optax.MultiSteps for b_accum_steps=2, the frozen group) fed the same
    gradients for 4 micro-steps, with clipping on and off;
  - ema_update on params and BN buffers, integers copied.
Tolerances: f32 arithmetic on both sides in another order. Parameters
after each step within 1e-3 of that step's learning rate plus 2 f32 ulps of
the parameter; grad_norm at rtol 1e-5 (an f32 sum of 6e5 squares, held
against its f64 value) and the EMA at rtol 1e-6. The schedule at rtol
1e-5 and atol 1e-6 of the peak: optax evaluates it in f32 (2e-6 off at
step 0, 1e-5 near the end, where cos is near -1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custom_d_fine_tpu.configs import get_model_config as jget
from custom_d_fine_tpu.models.dfine import DFINE as JDFINE
from custom_d_fine_tpu.train.ema import ema_update as jema_update
from custom_d_fine_tpu.train.optim import build_optimizer, label_params as jlabel
from custom_d_fine_tpu.train.optim import onecycle as jonecycle
from custom_d_fine_tpu.utils.torch_convert import convert_torch_state
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.train.ema import ema_update
from custom_d_fine_tpu_torch.train.optim import Optimizer, label_params, onecycle
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

from helpers import tiny_config
from test_torch_train_step import port_config
from torch_threads import few_threads  # noqa: F401  (autouse)

NC = 4
LR = dict(base_lr=2.5e-4, backbone_lr=6e-5, total_steps=100)


def _variable_shapes(cfg, img):
    model = JDFINE(cfg=cfg, num_classes=NC)
    G = cfg.max_gt
    dummy = {"labels": jnp.zeros((1, G), jnp.int32), "boxes": jnp.full((1, G, 4), 0.5),
             "valid": jnp.zeros((1, G), bool)}
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
        jnp.zeros((1, img, img, 3)), targets=dummy, train=True))


def _norm(tree):
    return float(np.sqrt(sum((np.asarray(a, np.float64) ** 2).sum()
                             for a in jax.tree_util.tree_leaves(tree))))


@pytest.fixture(scope="module")
def tiny_shapes():
    return _variable_shapes(tiny_config(), 160)


def test_optimizer_groups_match_label_params(tiny_shapes):
    """Each flax leaf is filled with the code of its JAX label and carried to
    the port's names by flax_to_torch: the tiny config, D-FINE-m, D-FINE-m
    with freeze_at=1 (the "frozen" label), and l and x (freeze_at=0)."""
    codes = ("backbone", "backbone_norm", "encdec_norm_bias", "rest", "frozen")
    m_shapes = _variable_shapes(jget("m"), 128)["params"]
    frozen = dict(freeze_at=1, freeze_stem_only=False)
    cases = [(tiny_config(), tiny_shapes["params"]), (jget("m"), m_shapes),
             (dataclasses.replace(jget("m"), backbone=dataclasses.replace(
                 jget("m").backbone, **frozen)), m_shapes)]
    cases += [(jget(size), _variable_shapes(jget(size), 128)["params"]) for size in ("l", "x")]
    for jcfg, shapes in cases:
        tcfg = port_config(jcfg)
        coded = jax.tree_util.tree_map(
            lambda lab, s: np.full(s.shape, codes.index(lab), np.float32),
            jlabel(shapes, jcfg), shapes)
        want = {k: codes[int(v.reshape(-1)[0])] for k, v in flax_to_torch(coded, {}).items()}
        got = label_params(tbuild(tcfg, NC, seed=0).named_parameters(), tcfg)
        assert set(want) == set(got), sorted(set(want) ^ set(got))[:5]
        assert want == got, [(k, want[k], got[k]) for k in want if want[k] != got[k]][:5]
        assert set(got.values()) >= set(codes[:4])
        if jcfg.backbone.freeze_at >= 0:
            assert "frozen" in set(got.values())


@pytest.mark.parametrize("total,pct", [(100, 0.1), (3, 0.1), (10, 0.3)])
def test_onecycle_matches_optax(total, pct):
    j, t = jonecycle(5e-4, total, pct), onecycle(5e-4, total, pct)
    for c in range(total + 2):
        np.testing.assert_allclose(t(c), float(j(c)), rtol=1e-5, atol=1e-6 * 5e-4,
                                   err_msg=(total, c))


@pytest.mark.parametrize("b_accum_steps,freeze_at,name,use_scheduler",
                         [pytest.param(1, -1, "tiny", True, id="1--1"),
                          pytest.param(2, 0, "tiny", True, id="2-0"),
                          pytest.param(1, 0, "l", True, id="1-0-l"),
                          pytest.param(2, 0, "x", True, id="2-0-x"),
                          pytest.param(1, -1, "tiny", False, id="1--1-constant-lr")])
def test_optimizer_matches_optax(tiny_shapes, b_accum_steps, freeze_at, name, use_scheduler):
    """build_optimizer's transformation and the port's Optimizer on the same
    params and gradients for 4 micro-steps. The gradients' global norms
    (5, 0.05, 2, 0.08) switch the clipping on and off; with b_accum_steps=2
    the clipping sees the mean of two micro-batches. Named "l" or "x", the
    tiny model takes the peak-lr rule of those sizes: the backbone groups
    cycle around 2 x backbone_lr instead of 2 x base_lr. use_scheduler=False
    keeps each group at its base lr (12.5x the warm-up's first lr): there
    the two sides' roundings of a parameter (torch's decoupled weight-decay
    multiply, optax's added term) add up step by step, and the tolerance's
    2 f32 ulps become 2 a step so far."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, name=name, backbone=dataclasses.replace(
        cfg.backbone, freeze_at=freeze_at))
    tcfg = port_config(cfg)
    model = tbuild(tcfg, NC, seed=0)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tiny_shapes)
    params, _, rep = convert_torch_state({k: v.numpy() for k, v in model.state_dict().items()},
                                         zeros["params"], zeros["batch_stats"], strict=True)
    assert not rep["missed"]
    tx = build_optimizer(params, cfg, b_accum_steps=b_accum_steps, use_scheduler=use_scheduler,
                         **LR)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt = Optimizer(model, tcfg, b_accum_steps=b_accum_steps, use_scheduler=use_scheduler,
                    **LR)
    named = dict(model.named_parameters())
    sched = jonecycle(2 * LR["base_lr"], LR["total_steps"], 0.1)
    rng = np.random.default_rng(0)
    for i, norm in enumerate((5.0, 0.05, 2.0, 0.08)):
        g = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape), params)
        scale = norm / _norm(g)
        g = jax.tree_util.tree_map(lambda a: (a * scale).astype(np.float32), g)
        params, opt_state = update(g, opt_state, params)
        for k, v in flax_to_torch(g, {}).items():
            named[k].grad = v.clone()
        got_norm = opt.step()
        np.testing.assert_allclose(float(got_norm), _norm(g), rtol=1e-5)
        lr = float(sched(i // b_accum_steps)) if use_scheduler else LR["base_lr"]
        ulps = 2 if use_scheduler else 2 * (i + 1)
        for k, w in flax_to_torch(params, {}).items():
            p = named[k].detach()
            tol = 1e-3 * lr + ulps * np.spacing(np.abs(w.numpy()))
            assert (np.abs(p.numpy() - w.numpy()) <= tol).all(), (i, k)


def test_ema_matches_jax():
    """Floating entries blend, integer entries (num_batches_tracked) are
    copied, at iteration counts on both sides of the warm-up."""
    rng = np.random.default_rng(1)
    shapes = {"a.weight": (3, 4), "a.bias": (4,), "bn.running_var": (5,)}
    ema = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    ema["bn.num_batches_tracked"] = torch.tensor(3)
    jema = {k: jnp.asarray(v.numpy()) for k, v in ema.items()}
    for iters in (1, 7, 5000):
        new = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for k, s in shapes.items()}
        new["bn.num_batches_tracked"] = torch.tensor(iters + 3)
        jema = jema_update(jema, {k: jnp.asarray(v.numpy()) for k, v in new.items()},
                           jnp.asarray(iters, jnp.int32))
        ema_update(ema, new, iters)
        for k, v in jema.items():
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7,
                                       err_msg=(iters, k))
    assert int(ema["bn.num_batches_tracked"]) == 5003
