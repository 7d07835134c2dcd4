"""The training slice's first-step gradients in float64 on both sides: the
port's DFINE + DFINECriterion (plain kernel versions on the CPU) against
jax.value_and_grad of the JAX package's loss, under jax.enable_x64, on the
state, batch and denoising draws of tests/test_torch_train_step.py.

Why. In float32 the backbone gradient of this tiny config is
ill-conditioned: a ReLU input within f32 rounding of zero sends one
position's gradient one way on one side and the other way on the other, and
the float32 gradients of the two packages differ by up to 9e-3 per backbone
tensor (relative L2). This test is the independent witness of which side
strays. In float64 the two packages agree (2.6e-7 over the backbone); the
port's float32 gradients stay within 1.3e-4 of JAX's float64 ones, while
JAX's own float32 gradients are 9e-3 from them.

Three test-side substitutions let the JAX package run in float64; none
changes its files:
  - FlatBatchNorm (custom_d_fine_tpu/models/layers.py:148,193) normalizes in
    float32 by an explicit cast; that module's `jnp.float32` is float64 here;
  - build_cdn_group draws its noise as it does without x64 (float32 uniform,
    int32 randint): under x64 jax.random defaults to 64-bit types, which
    draw other numbers;
  - the LAPJV solver (ops/lapjv.py) types its loop carries float32 and does
    not trace under x64; the assignment comes from the JAX package's own
    host solver (ops/hungarian.py:host_solve) through pure_callback.

Left out of the float64 comparison: the cross-attention sampling_offsets
gradients. On this data 39 of the 25,600 sampling coordinates of each
decoder layer lie within 1e-9 of an integer pixel coordinate, where
bilinear sampling has a kink and the gradient takes the side that the last
bit of the location picks (float64 measured 7-9% apart there); the test
checks that such points exist. Those tensors are held against the JAX
package in float32 in tests/test_torch_train_step.py.

Tolerances. The criterion casts its inputs to float32 on both sides, so
float64 agreement stops near float32's rounding. Every loss term: rtol 2e-6
(measured 4.2e-7). Gradients, relative L2 per tensor whose gradient norm is
at least 1e-6 of the global norm: float64 port against float64 JAX 2e-5
(measured 4.7e-6, a scalar LearnableAffineBlock gradient that sums every
position; 1.3e-6 for the rest of the backbone), and 1e-6 over the backbone
as a whole (measured 2.6e-7); float32 port against float64 JAX, backbone
tensors above 1e-3 of the global norm, 1e-3 (measured 1.3e-4), and 2e-4
over the backbone (measured 3.7e-5).
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.models import decoder as jdecoder
from custom_d_fine_tpu.models import denoising as jdenoising
from custom_d_fine_tpu.models import layers as jlayers
from custom_d_fine_tpu.models.dfine import DFINE as JDFINE
from custom_d_fine_tpu.ops.hungarian import host_solve
from custom_d_fine_tpu.train import matcher as jmatcher
from custom_d_fine_tpu.train.criterion import DFINECriterion as JCriterion
from custom_d_fine_tpu_torch.models import decoder as tdecoder
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.ops.msda import msda
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch, flax_train_state_to_torch

from helpers import tiny_config
from test_torch_train_step import DN_KEY, NC, batches, initial_state, jax_dn_draws, port_config

FLOOR = 1e-6
F64_RTOL, F64_BACKBONE_RTOL = 2e-5, 1e-6
F32_FLOOR, F32_RTOL, F32_BACKBONE_RTOL = 1e-3, 1e-3, 2e-4
LOSS_RTOL = 2e-6
KINKED = "cross_attn.sampling_offsets."


class _Shim(types.ModuleType):
    """`base` with some attributes replaced."""

    def __init__(self, base, **replaced):
        super().__init__(base.__name__)
        self._base = base
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _host_assignment(costs, n_valid):
    S, B, _, G = costs.shape
    return jax.pure_callback(lambda c, n: host_solve(np.asarray(c), np.asarray(n)),
                             jax.ShapeDtypeStruct((S, B, G), jnp.int32), costs, n_valid)


def jax_f64(cfg, variables, batch):
    """value_and_grad of make_train_step's loss_fn (train_step.py:75-88) in
    float64: (losses, grads as port state_dict names)."""
    model = JDFINE(cfg=cfg, num_classes=NC)
    criterion = JCriterion(cfg.criterion, cfg.matcher, num_classes=NC,
                           num_queries=cfg.decoder.num_queries)

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)

    def loss_fn(params, batch_stats, batch):
        images = batch["images"].astype(jnp.float64) / 255.0
        targets = {"labels": batch["labels"], "valid": batch["valid"],
                   "boxes": batch["boxes"].astype(jnp.float64)}
        outputs, _ = model.apply({"params": params, "batch_stats": batch_stats}, images,
                                 targets=targets, train=True, rngs={"dn": DN_KEY},
                                 mutable=["batch_stats"])
        losses = criterion(outputs, targets)
        return jnp.sum(jnp.stack(list(losses.values()))), losses

    random = _Shim(jax.random,
                   uniform=lambda key, shape: jax.random.uniform(key, shape, jnp.float32),
                   randint=lambda key, shape, lo, hi, dtype=jnp.int32:
                   jax.random.randint(key, shape, lo, hi, dtype))
    orig = jdecoder.build_cdn_group
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jlayers, "jnp", _Shim(jnp, float32=jnp.float64))
        mp.setattr(jdenoising, "jax", _Shim(jax, random=random))
        mp.setattr(jmatcher, "batched_assignment", _host_assignment)
        mp.setattr(jdecoder, "build_cdn_group", lambda rng, *a, **k: orig(DN_KEY, *a, **k))
        (_, losses), grads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64(variables["params"]), f64(variables["batch_stats"]),
            {k: jnp.asarray(v) for k, v in batch.items()}))
    return ({k: float(v) for k, v in losses.items()},
            {k: v.double() for k, v in flax_to_torch(grads, {}).items()})


def port_grads(tcfg, variables, batch, draws, dtype, kinks=None):
    """(losses, grads); kinks, a list, gets the number of sampling
    coordinates within 1e-9 of a bilinear kink in each MSDA call."""
    sd, _ = flax_train_state_to_torch(variables["params"], variables["batch_stats"])
    model = tbuild(tcfg, NC, seed=0)
    model.load_state_dict(sd)
    model.to(dtype).train()
    x = torch.from_numpy(batch["images"]).to(dtype).div(255.0).permute(0, 3, 1, 2)
    targets = {"labels": torch.from_numpy(batch["labels"]),
               "valid": torch.from_numpy(batch["valid"]),
               "boxes": torch.from_numpy(batch["boxes"]).to(dtype)}
    crit = DFINECriterion(tcfg.criterion, tcfg.matcher, num_classes=NC)

    def spy(value, shapes, loc, attn, num_points):
        if kinks is not None:
            hw = torch.tensor([[w, h] for (h, w), p in zip(shapes, num_points) for _ in range(p)],
                              dtype=loc.dtype)
            px = loc.detach() * hw - 0.5
            kinks.append(int(((px - px.round()).abs() < 1e-9).sum()))
        return msda(value, shapes, loc, attn, num_points)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdecoder, "msda", spy)
        losses = crit(model(x, targets=targets, dn_draws=draws), targets)
    torch.stack(list(losses.values())).sum().backward()
    return ({k: v.item() for k, v in losses.items()},
            {k: p.grad.double() for k, p in model.named_parameters()})


def _errors(got, want, names, floor):
    per = {k: float((got[k] - want[k]).norm() / want[k].norm())
           for k in names if want[k].norm() >= floor}
    whole = math.sqrt(sum(float(((got[k] - want[k]) ** 2).sum()) for k in names)
                      / sum(float((want[k] ** 2).sum()) for k in names))
    return per, whole


def test_first_step_gradients_f64_match_jax_f64():
    cfg = tiny_config()
    tcfg = port_config(cfg)
    _, variables = initial_state(cfg, tcfg)
    batch = batches(cfg, 1)[0]
    draws = jax_dn_draws(cfg, batch["images"].shape[0], NC)
    want_losses, want = jax_f64(cfg, variables, batch)
    kinks = []
    got_losses, got = port_grads(tcfg, variables, batch, draws, torch.float64, kinks)
    assert len(kinks) == cfg.decoder.num_layers and min(kinks) > 0, kinks
    assert set(got_losses) == set(want_losses)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k], v, rtol=LOSS_RTOL, err_msg=k)

    assert set(got) == set(want)
    norm = math.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    backbone = [k for k in want if k.startswith("backbone.")]
    per, _ = _errors(got, want, [k for k in want if KINKED not in k], FLOOR * norm)
    worst = max(per, key=per.get)
    assert per[worst] <= F64_RTOL, f"{worst}: relative L2 error {per[worst]:.2e}"
    assert len(per) > 0.75 * len(want)
    _, whole = _errors(got, want, backbone, 0.0)
    assert whole <= F64_BACKBONE_RTOL, f"backbone gradient: relative L2 error {whole:.2e}"

    # the port's float32 backward, on the ill-conditioned backbone
    _, got32 = port_grads(tcfg, variables, batch, draws, torch.float32)
    per, _ = _errors(got32, want, backbone, F32_FLOOR * norm)
    worst = max(per, key=per.get)
    assert per[worst] <= F32_RTOL, f"float32 {worst}: relative L2 error {per[worst]:.2e}"
    _, whole = _errors(got32, want, backbone, 0.0)
    assert whole <= F32_BACKBONE_RTOL, f"float32 backbone gradient: relative L2 error {whole:.2e}"
