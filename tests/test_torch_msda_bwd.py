"""The port's MSDA backward (custom_d_fine_tpu_torch/ops/msda.py: MSDAFunction,
whose backward is msda_bwd; its plain version msda_bwd_plain on the CPU)
against jax.grad through the JAX package's two TPU backward kernels run in
interpret mode, as tests/test_deform_attn.py:120-292 runs them:
  - ops/pallas/msda_sep.py:_sep_bwd_kernel, the branch of levels with
    HW >= _SEP_BWD_MIN_HW (1024), through ms_deform_attn_sep;
  - ops/pallas/msda.py:_level_bwd_kernel, the small levels, through
    ms_deform_attn_pallas and through the small level of ms_deform_attn_sep.
Locations include the border and out-of-range points of
tests/test_deform_attn.py:48-52.

Tolerances: f32 at rtol=1e-4, atol=1e-5 (the JAX package's own bound for
these kernels); a bf16 value map at the scaled atol 0.02 of
tests/test_deform_attn.py:345. msda_bwd_plain against torch.autograd of the
plain forward at rtol=1e-5, atol=1e-6 (f32, the same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from custom_d_fine_tpu.ops.deform_attn import ms_deform_attn_xla
from custom_d_fine_tpu.ops.pallas import msda_sep
from custom_d_fine_tpu.ops.pallas.msda import ms_deform_attn_pallas
from custom_d_fine_tpu_torch.ops.msda import (level_start_index, msda, msda_bwd,
                                              msda_bwd_plain, msda_fwd, msda_fwd_plain)

from test_torch_msda import _inputs

TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = ("dvalue", "dloc", "dattn")


def _cotangent(value, loc, seed):
    B, Lq, nh = loc.shape[:3]
    c = value.shape[-1]
    return np.random.default_rng(seed).normal(size=(B, Lq, nh * c)).astype(np.float32)


def _jax_grads(fn, value, loc, attn, cot, interpret=True):
    def f(v, l, a):
        return (fn(v, l, a).astype(jnp.float32) * cot).sum()

    args = (jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    if not interpret:
        return [np.asarray(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(value, shapes, loc, attn, points, cot, value_dtype=torch.float32):
    """Gradients of sum(msda(...) * cot) through MSDAFunction on the CPU."""
    launches = (msda_fwd.launches, msda_bwd.launches)
    v = torch.from_numpy(value).to(value_dtype).requires_grad_()
    l = torch.from_numpy(loc).requires_grad_()
    a = torch.from_numpy(attn).requires_grad_()
    (msda(v, shapes, l, a, points) * torch.from_numpy(cot)).sum().backward()
    assert (msda_fwd.launches, msda_bwd.launches) == launches  # CPU: plain versions
    assert (v.grad.dtype, l.grad.dtype, a.grad.dtype) == (value_dtype, torch.float32,
                                                          torch.float32)
    return [t.grad.float().numpy() for t in (v, l, a)]


def test_grads_match_sep_bwd_kernel_interpret():
    """A 40x40 level (1600 >= 1024: _sep_bwd_kernel) and a 3x4 level (the
    compare branch, _level_bwd_kernel)."""
    shapes, points = [(40, 40), (3, 4)], [2, 3]
    assert shapes[0][0] * shapes[0][1] >= msda_sep._SEP_BWD_MIN_HW > 12
    value, loc, attn = _inputs(shapes, points, B=2, Lq=5, seed=11, lo=-0.15, hi=1.15)
    cot = _cotangent(value, loc, 1)
    want = _jax_grads(lambda v, l, a: msda_sep.ms_deform_attn_sep(v, shapes, l, a, points),
                      value, loc, attn, cot)
    got = _port_grads(value, shapes, loc, attn, points, cot)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_grads_match_level_bwd_kernel_interpret():
    """Small levels only: every level through _level_bwd_kernel."""
    shapes, points = [(6, 8), (3, 4)], [2, 3]
    value, loc, attn = _inputs(shapes, points, seed=5, lo=-0.15, hi=1.15)
    cot = _cotangent(value, loc, 2)
    want = _jax_grads(lambda v, l, a: ms_deform_attn_pallas(v, shapes, l, a, points),
                      value, loc, attn, cot)
    got = _port_grads(value, shapes, loc, attn, points, cot)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_bf16_value_grads_within_scaled_tolerance():
    """bf16 value map (the card's training precision) against the f32 XLA
    grads and against the TPU kernels' fast (bf16) backward in interpret
    mode, as test_deform_attn.py:313-346 bounds the latter."""
    shapes, points = [(40, 40), (3, 4)], [2, 3]
    value, loc, attn = _inputs(shapes, points, B=2, Lq=5, seed=13, lo=-0.15, hi=1.15)
    cot = _cotangent(value, loc, 3)
    got = _port_grads(value, shapes, loc, attn, points, cot, value_dtype=torch.bfloat16)
    want = _jax_grads(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a, points),
                      value, loc, attn, cot, interpret=False)
    fast = _jax_grads(lambda v, l, a: msda_sep.ms_deform_attn_sep(
        v.astype(jnp.bfloat16), shapes, l, a, points, fast=True), value, loc, attn, cot)
    for name, g, w, f in zip(NAMES, got, want, fast):
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, atol=0.02, err_msg=name)
        np.testing.assert_allclose(g / scale, f / scale, atol=0.02, err_msg=name)


@pytest.mark.parametrize("shapes,points", [
    ([(6, 8), (3, 4)], [2, 3]),
    ([(8, 8), (4, 4), (2, 2)], [3, 6, 3]),
])
def test_bwd_plain_matches_autograd(shapes, points):
    """msda_bwd_plain written out against torch.autograd of msda_fwd_plain,
    with corners outside the map (which must give zero gradient)."""
    value, loc, attn = _inputs(shapes, points, seed=7, lo=-0.3, hi=1.3)
    cot = torch.from_numpy(_cotangent(value, loc, 4))
    v, l, a = (torch.from_numpy(t).requires_grad_() for t in (value, loc, attn))
    starts = level_start_index(shapes)
    (msda_fwd_plain(v, shapes, starts, l, a, points) * cot).sum().backward()
    got = msda_bwd_plain(v.detach(), shapes, starts, l.detach(), a.detach(), cot, points)
    for name, g, t in zip(NAMES, got, (v, l, a)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the far-out point loc[-1, 0, 1, -1] touches no corner: no gradient at all
    assert float(got[1][-1, 0, 1, -1].abs().sum()) == 0.0
    assert float(got[2][-1, 0, 1, -1].abs()) == 0.0


def test_function_casts_at_its_boundary():
    """Under autocast loc and attn may arrive in bf16: the Function computes
    in f32 and returns each gradient in its input's dtype."""
    shapes, points = [(6, 8), (3, 4)], [2, 3]
    value, loc, attn = _inputs(shapes, points, seed=3)
    v = torch.from_numpy(value).to(torch.bfloat16).requires_grad_()
    l = torch.from_numpy(loc).to(torch.bfloat16).requires_grad_()
    a = torch.from_numpy(attn).to(torch.bfloat16).requires_grad_()
    out = msda(v, shapes, l, a, points)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert (v.grad.dtype, l.grad.dtype, a.grad.dtype) == (torch.bfloat16,) * 3
