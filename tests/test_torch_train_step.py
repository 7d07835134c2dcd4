"""The training slice as a whole: the port's train step
(custom_d_fine_tpu_torch/train/train_step.py, plain kernel versions on the
CPU, f32) against the JAX package's training step (msda_impl="xla" on the
CPU) on tests/helpers.py:tiny_config() at 160x160, batch 2, uint8 images:
2 optimizer steps with b_accum_steps=1, and 4 micro-steps (2 updates) with
b_accum_steps=2.

The JAX side is create_train_state and make_train_step's body
(custom_d_fine_tpu/train/train_step.py:32-115) built from the JAX package's
own pieces, each jitted once for both cases: its loss_fn under
value_and_grad, build_optimizer's transformation with optax.apply_updates,
and ema_update. Accumulation on that side is the mean of the micro-batch
gradients into the same transformation, which is what optax.MultiSteps
computes; tests/test_torch_optim.py holds the port against MultiSteps
itself, and tests/test_train_step.py runs make_train_step.

Both sides start from the same state: the port's seeded random weights
(conv kernels x sqrt(6), so that query selection does not tie) go into the
flax tree with the JAX package's convert_torch_state; the JAX TrainState
(params, BN statistics, EMA) comes back through utils/weights.py; AdamW
starts at zero on both sides. The denoising noise is the same: the JAX
decoder's build_cdn_group gets a fixed key, the port the draws JAX makes
from it.

Tolerances (f32 on both sides). The forward differs by float reassociation
only. The backward of the backbone is ill-conditioned at this size: a ReLU
whose input lies within f32 rounding of zero sends one position's gradient
one way on one side and the other way on the other. On the data here one
such input (4.8e-7, stages.0 aggregation squeeze) moves the JAX package's
stem gradients by up to 9e-3 (relative L2) from the port's.
tests/test_torch_train_grad_f64.py shows that the JAX package is the side
that strays: in float64 the two agree to 2.6e-7 over the backbone, and the
port's float32 backbone gradients are within 1.3e-4 of JAX's float64 ones.
  - every loss term and total_loss: rtol 1e-4, atol 1e-6 before the first
    update (measured 2e-6); rtol 1e-3 after it (measured 7e-5), since the
    backbone's update carries the gradient difference above;
  - the pre-clip grad_norm: rtol 6e-3 (the backbone, above; measured 1.1e-4
    before the first update, 3.0e-3 after it);
  - first-step gradients, relative L2: per tensor 5e-3 outside the backbone
    (measured 1e-3); the backbone as a whole 5e-3 (measured 3.3e-3), and
    each of its tensors 1.2e-2 (measured 9.3e-3). Tensors whose gradient
    norm is below 1e-5 (outside) or 1e-3 (backbone) of the global norm are
    left out (81 of 372 here): most are zero in exact arithmetic (a
    LearnableAffineBlock or a bias that a BatchNorm cancels), and a scalar
    LearnableAffineBlock gradient next to the ill-conditioned ReLU sums
    every position's error (14% on the data here);
  - BatchNorm running statistics: rtol 1e-3, atol 1e-4 (measured 1e-5;
    flax's biased running variance and torch's unbiased one differ by 0.2%
    of the variance per update on the 5x5 maps);
  - parameters and EMA, as updates in units of the summed learning rate
    (Adam moves an element by ~1 lr per step): every element within 2.05
    (a gradient within noise of zero may take either sign), and at most 1%
    of the elements outside the backbone and 5% in it beyond 0.05 (measured
    0.07% and 1.8%).
The optimizer and the EMA are held exactly, on equal gradients, in
tests/test_torch_optim.py.
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custom_d_fine_tpu.models import decoder as jdecoder
from custom_d_fine_tpu.models.denoising import dn_layout as jdn_layout
from custom_d_fine_tpu.models.dfine import DFINE as JDFINE
from custom_d_fine_tpu.train.criterion import DFINECriterion as JCriterion
from custom_d_fine_tpu.train.ema import ema_update as jema_update
from custom_d_fine_tpu.train.optim import build_optimizer, onecycle as jonecycle
from custom_d_fine_tpu.utils.torch_convert import convert_torch_state
from custom_d_fine_tpu_torch.configs import registry as treg
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.train import train_step as ttrain
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch, flax_train_state_to_torch

from helpers import make_targets, tiny_config

IMG, B, NC = 160, 2, 4
LR = dict(base_lr=2.5e-4, backbone_lr=6e-5, total_steps=100)
DN_KEY = jax.random.PRNGKey(123)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL_UPDATED = dict(rtol=1e-3, atol=1e-6)
GRAD_NORM_RTOL = 6e-3
GRAD_RTOL = {"backbone": 1.2e-2, "other": 5e-3}
GRAD_FLOOR = {"backbone": 1e-3, "other": 1e-5}
BACKBONE_RTOL = 5e-3
STAT_TOL = dict(rtol=1e-3, atol=1e-4)
UPD_ATOL, UPD_SHARE = 0.05, {"backbone": 0.05, "other": 0.01}


def port_config(cfg):
    """The same ModelConfig in the port's own registry classes."""
    d = dataclasses.asdict(cfg)
    return treg.ModelConfig(
        name=d["name"], backbone=treg.BackboneConfig(**d["backbone"]),
        encoder=treg.EncoderConfig(**d["encoder"]), decoder=treg.DecoderConfig(**d["decoder"]),
        criterion=treg.CriterionConfig(**d["criterion"]),
        matcher=treg.MatcherConfig(**d["matcher"]), max_gt=d["max_gt"],
        dn_max_gt=d["dn_max_gt"])


def jax_dn_draws(cfg, batch_size, num_classes):
    """The draws build_cdn_group makes from DN_KEY (denoising.py:102-116)."""
    d = cfg.decoder
    _, num_dn, _ = jdn_layout(d.num_denoising, cfg.dn_max_gt, d.num_queries)
    k_label, k_sign, k_part = jax.random.split(DN_KEY, 3)
    shape = (batch_size, num_dn)
    draws = {"flip_u": jax.random.uniform(k_label, shape),
             "new_label": jax.random.randint(k_label, shape, 0, num_classes, dtype=jnp.int32),
             "sign": jax.random.randint(k_sign, shape + (4,), 0, 2),
             "part": jax.random.uniform(k_part, shape + (4,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def initial_state(cfg, tcfg):
    """flax variables holding the port's seeded weights (no JAX init compile:
    the tree's shapes come from eval_shape)."""
    tm = tbuild(tcfg, NC, seed=0)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(math.sqrt(6.0))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    model = JDFINE(cfg=cfg, num_classes=NC)
    G = cfg.max_gt
    dummy = {"labels": jnp.zeros((B, G), jnp.int32), "boxes": jnp.full((B, G, 4), 0.5),
             "valid": jnp.zeros((B, G), bool)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
        jnp.zeros((B, IMG, IMG, 3)), targets=dummy, train=True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, rep = convert_torch_state(sd, zeros["params"], zeros["batch_stats"],
                                             strict=True)
    assert not rep["missed"], rep["missed"][:5]
    return model, {"params": params, "batch_stats": stats}


def batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = make_targets(B, cfg.max_gt, NC, rng, n_valid=4)
        out.append({"images": rng.integers(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
                    **{k: np.asarray(v) for k, v in t.items()}})
    return out


@pytest.fixture(scope="module")
def ref():
    """The shared JAX side: initial state, data, DN draws and the jitted
    value_and_grad of make_train_step's loss_fn (train_step.py:75-88)."""
    cfg = tiny_config()
    tcfg = port_config(cfg)
    model, variables = initial_state(cfg, tcfg)
    criterion = JCriterion(cfg.criterion, cfg.matcher, num_classes=NC,
                           num_queries=cfg.decoder.num_queries)

    def loss_fn(params, batch_stats, batch):
        images = batch["images"].astype(jnp.float32) / 255.0
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        outputs, mutated = model.apply({"params": params, "batch_stats": batch_stats}, images,
                                       targets=targets, train=True, rngs={"dn": DN_KEY},
                                       mutable=["batch_stats"])
        losses = criterion(outputs, targets)
        return jnp.sum(jnp.stack(list(losses.values()))), (losses, mutated["batch_stats"])

    data = batches(cfg, 4)
    value_and_grad = jax.value_and_grad(loss_fn, has_aux=True)

    @jax.jit
    def grad_fn(params, batch_stats, batch):
        out, grads = value_and_grad(params, batch_stats, batch)
        return out, grads, optax.global_norm(grads)

    orig = jdecoder.build_cdn_group
    with pytest.MonkeyPatch.context() as mp:  # traced once, under the fixed key
        mp.setattr(jdecoder, "build_cdn_group", lambda rng, *a, **k: orig(DN_KEY, *a, **k))
        first = jax.device_get(grad_fn(variables["params"], variables["batch_stats"],
                                       {k: jnp.asarray(v) for k, v in data[0].items()}))
    tx = build_optimizer(variables["params"], cfg, **LR)

    @jax.jit
    def update(grads, opt_state, params):  # train_step.py:92-93
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return SimpleNamespace(cfg=cfg, tcfg=tcfg, variables=variables, grad_fn=grad_fn,
                           data=data, draws=jax_dn_draws(cfg, B, NC), first=first,
                           opt_init=jax.jit(tx.init), update=update,
                           ema_update=jax.jit(jema_update))


def jax_steps(ref, b_accum_steps, n_micro):
    """create_train_state and make_train_step's body (train_step.py:32-115)
    over n_micro batches. Accumulation is what optax.MultiSteps computes: the
    inner transformation's update on the mean of b_accum_steps micro-batch
    gradients, and nothing on the other micro-steps (tests/test_torch_optim.py
    holds the port against optax.MultiSteps itself); so both cases share one
    compiled update."""
    params, stats = ref.variables["params"], ref.variables["batch_stats"]
    opt_state = ref.opt_init(params)
    ema = {"params": params, "batch_stats": stats}
    metrics, acc = [], []
    for i, batch in enumerate(ref.data[:n_micro]):
        (total, (losses, stats)), grads, grad_norm = ref.grad_fn(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append(jax.device_get({"total_loss": total, "grad_norm": grad_norm, **losses}))
        acc.append(jax.device_get(grads))
        step = i + 1
        if step % b_accum_steps:
            continue
        mean = jax.tree_util.tree_map(lambda *g: sum(g) / np.float32(len(g)), *acc)
        acc = []
        params, opt_state = ref.update(mean, opt_state, params)
        ema = ref.ema_update(ema, {"params": params, "batch_stats": stats},  # :96-108
                             jnp.asarray(step // b_accum_steps, jnp.int32))
    return jax.device_get((params, stats, ema)), metrics


def port_steps(ref, b_accum_steps, n_micro):
    v = ref.variables
    sd, ema = flax_train_state_to_torch(v["params"], v["batch_stats"],
                                        {"params": v["params"], "batch_stats": v["batch_stats"]})
    tstep, tstate = ttrain.build_training(ref.tcfg, NC, device="cpu", bf16=False, state_dict=sd,
                                          ema=ema, b_accum_steps=b_accum_steps, **LR)
    init = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "draw_dn_noise", lambda *a, **k: ref.draws)
        for batch in ref.data[:n_micro]:
            tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.Generator())
            metrics.append({k: v.numpy() for k, v in m.items()})
    return init, tstate, metrics


def _region(name):
    return "backbone" if name.startswith("backbone.") else "other"


def check_updates(init, want, got, lr_sum, what):
    """want/got: state_dicts after the steps; see the module docstring."""
    beyond = {"backbone": [0, 0], "other": [0, 0]}
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        err = ((got[k] - init[k]).double() - (w - init[k]).double()).abs().numpy() / lr_sum
        assert err.max() <= 2.05, f"{what} {k}: update differs by {err.max():.3f} lr"
        b = beyond[_region(k)]
        b[0] += int((err > UPD_ATOL).sum())
        b[1] += err.size
    for region, (n, size) in beyond.items():
        assert n <= UPD_SHARE[region] * size, \
            f"{what}: {n} of {size} {region} elements differ by more than {UPD_ATOL} lr"


def test_first_step_gradients_match_jax(ref):
    """The port's forward + criterion + backward on the initial state against
    jax.value_and_grad of the JAX package's loss_fn, tensor by tensor."""
    (total, (losses, _)), grads, _ = ref.first
    sd, _ = flax_train_state_to_torch(ref.variables["params"], ref.variables["batch_stats"])
    model = tbuild(ref.tcfg, NC, seed=0)
    model.load_state_dict(sd)
    model.train()
    batch = ref.data[0]
    x = torch.from_numpy(batch["images"]).float().div(255.0).permute(0, 3, 1, 2)
    targets = {k: torch.from_numpy(batch[k]) for k in ("labels", "boxes", "valid")}
    crit = ttrain.DFINECriterion(ref.tcfg.criterion, ref.tcfg.matcher, num_classes=NC)
    got = crit(model(x, targets=targets, dn_draws=ref.draws), targets)
    assert set(got) == set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(got[k].item(), v, **LOSS_TOL, err_msg=k)
    torch.stack(list(got.values())).sum().backward()
    want = {k: v.double() for k, v in flax_to_torch(grads, {}).items()}
    got = {k: p.grad.double() for k, p in model.named_parameters()}
    assert set(want) == set(got)
    global_norm = math.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    compared = 0
    for k, w in want.items():
        floor = GRAD_FLOOR[_region(k)] * global_norm
        if w.norm() >= floor:
            rel = float((got[k] - w).norm() / w.norm())
            assert rel <= GRAD_RTOL[_region(k)], f"{k}: relative L2 error {rel:.2e}"
            compared += 1

    assert compared > 0.75 * len(want)
    bb = [k for k in want if _region(k) == "backbone"]
    rel = math.sqrt(sum(float(((got[k] - want[k]) ** 2).sum()) for k in bb)
                    / sum(float((want[k] ** 2).sum()) for k in bb))
    assert rel <= BACKBONE_RTOL, f"backbone gradient: relative L2 error {rel:.2e}"


@pytest.mark.parametrize("b_accum_steps,n_micro", [(1, 2), (2, 4)])
def test_train_steps_match_jax(ref, b_accum_steps, n_micro):
    """Two optimizer updates: 2 micro-steps without accumulation, 4 with
    b_accum_steps=2 (optax.MultiSteps on the JAX side)."""
    (params, stats, ema), jmetrics = jax_steps(ref, b_accum_steps, n_micro)
    init, tstate, tmetrics = port_steps(ref, b_accum_steps, n_micro)

    for step, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        assert set(jm) == set(tm), sorted(set(jm) ^ set(tm))
        for k in jm:
            tol = (dict(rtol=GRAD_NORM_RTOL) if k == "grad_norm" else
                   LOSS_TOL if step < b_accum_steps else LOSS_TOL_UPDATED)
            np.testing.assert_allclose(tm[k], jm[k], **tol, err_msg=f"step {step} {k}")

    n_updates = n_micro // b_accum_steps
    sched = jonecycle(2 * LR["base_lr"], LR["total_steps"], 0.1)  # tiny: one peak for all
    lr_sum = float(sum(sched(i) for i in range(n_updates)))
    want = flax_to_torch(params, stats)
    got = tstate.model.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), **STAT_TOL, err_msg=k)
    check_updates(init, want, got, lr_sum, "params")
    want_ema = flax_to_torch(ema["params"], ema["batch_stats"])
    assert set(want_ema) == set(tstate.ema)
    for k, w in want_ema.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(tstate.ema[k].numpy(), w.numpy(), **STAT_TOL, err_msg=k)
    check_updates(init, want_ema, tstate.ema, lr_sum, "ema")
