"""The port's MSDA (custom_d_fine_tpu_torch/ops/msda.py, plain version on the
CPU) against the JAX package's ms_deform_attn_xla and its two TPU kernels run
in interpret mode (_sep_kernel via ms_deform_attn_sep, _level_kernel via
ms_deform_attn_pallas), with border and out-of-range locations as in
tests/test_deform_attn.py:48-52.

f32 is held at rtol=atol=1e-5; a bf16 value map at the scaled atol 0.02 of
tests/test_deform_attn.py:344-346."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from custom_d_fine_tpu.ops.deform_attn import ms_deform_attn_xla
from custom_d_fine_tpu.ops.pallas.msda import ms_deform_attn_pallas
from custom_d_fine_tpu.ops.pallas.msda_sep import ms_deform_attn_sep
from custom_d_fine_tpu_torch.ops.msda import level_start_index, msda_fwd, msda_fwd_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shapes, points, B=2, Lq=6, nh=2, c=8, seed=0, lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    P = sum(points)
    Lv = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, Lv, nh, c)).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(B, Lq, nh, P, 2)).astype(np.float32)
    loc[0, 0, 0, 0] = [0.0, 0.0]      # top-left corner
    loc[0, 1, 0, 0] = [1.0, 1.0]      # bottom-right edge
    loc[0, 2, 0, 0] = [-0.2, 0.5]     # partially out left
    loc[0, 3, 0, 0] = [0.999, 0.001]
    loc[-1, 0, 1, -1] = [7.5, -3.0]   # far out of range
    attn = rng.uniform(0, 1, size=(B, Lq, nh, P)).astype(np.float32)
    return value, loc, attn


def _port(value, shapes, loc, attn, points):
    launches = msda_fwd.launches
    out = msda_fwd(torch.from_numpy(value), shapes, level_start_index(shapes),
                   torch.from_numpy(loc), torch.from_numpy(attn), points)
    assert msda_fwd.launches == launches  # CPU tensors take the plain version
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("shapes,points", [
    ([(6, 8), (3, 4)], [2, 3]),
    ([(8, 8), (4, 4), (2, 2)], [3, 6, 3]),
])
def test_plain_matches_xla(shapes, points):
    value, loc, attn = _inputs(shapes, points)
    want = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes, jnp.asarray(loc),
                                         jnp.asarray(attn), points))
    np.testing.assert_allclose(_port(value, shapes, loc, attn, points), want, **TOL)


def test_plain_matches_sep_kernel_interpret():
    """A level of >= 1024 positions takes the separable _sep_kernel, the small
    one the compare-accumulate _level_kernel (test_deform_attn.py:205-225)."""
    shapes, points = [(64, 64), (3, 4)], [2, 2]
    value, loc, attn = _inputs(shapes, points, B=1, seed=9)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ms_deform_attn_sep(jnp.asarray(value), shapes, jnp.asarray(loc),
                                             jnp.asarray(attn), points))
    np.testing.assert_allclose(_port(value, shapes, loc, attn, points), want, **TOL)


def test_plain_matches_level_kernel_interpret():
    shapes, points = [(6, 8), (3, 4)], [2, 3]
    value, loc, attn = _inputs(shapes, points, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ms_deform_attn_pallas(jnp.asarray(value), shapes, jnp.asarray(loc),
                                                jnp.asarray(attn), points))
    np.testing.assert_allclose(_port(value, shapes, loc, attn, points), want, **TOL)


def test_plain_matches_psum_kernel_interpret(monkeypatch):
    """The third TPU forward kernel, msda_sep.py:_sep_kernel_psum (the P-sum
    inside the kernel, chosen by MSDA_FWD_PSUM=1), computes the same
    function: held against the port as test_deform_attn.py:349 holds it
    against _sep_kernel. Exact mode at TOL; fast (bf16) mode against a bf16
    value map at the scaled atol 0.02."""
    from custom_d_fine_tpu.ops.pallas import msda_sep

    shapes, points = [(64, 64), (3, 4)], [2, 3]  # 4096: the separable branch
    value, loc, attn = _inputs(shapes, points, B=2, Lq=5, seed=17, lo=-0.1, hi=1.1)
    monkeypatch.setattr(msda_sep, "_FWD_PSUM", True)
    with pltpu.force_tpu_interpret_mode():
        exact, fast = (np.asarray(msda_sep._msda_sep_fwd_impl(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn), points,
            fast=f), np.float32) for f in (False, True))
    np.testing.assert_allclose(_port(value, shapes, loc, attn, points), exact, **TOL)
    got16 = msda_fwd(torch.from_numpy(value).to(torch.bfloat16), shapes,
                     level_start_index(shapes), torch.from_numpy(loc),
                     torch.from_numpy(attn), points).numpy()
    scale = max(np.abs(exact).max(), 1e-6)
    np.testing.assert_allclose(got16 / scale, fast / scale, atol=0.02)


def test_bf16_value_within_scaled_tolerance():
    """bf16 value (the serving precision on the card) against the f32 XLA
    reference and against the TPU serving kernel (fast mode, interpret)."""
    shapes, points = [(40, 40), (3, 4)], [2, 3]
    value, loc, attn = _inputs(shapes, points, seed=13, lo=-0.15, hi=1.15)
    got = msda_fwd(torch.from_numpy(value).to(torch.bfloat16), shapes,
                   level_start_index(shapes), torch.from_numpy(loc),
                   torch.from_numpy(attn), points).numpy()
    want = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes, jnp.asarray(loc),
                                         jnp.asarray(attn), points))
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=0.02)
    with pltpu.force_tpu_interpret_mode():
        fast = np.asarray(ms_deform_attn_sep(jnp.asarray(value), shapes, jnp.asarray(loc),
                                             jnp.asarray(attn), points, fast=True),
                          np.float32)
    np.testing.assert_allclose(got / scale, fast / scale, atol=0.02)


def test_plain_rejects_wrong_level_start():
    shapes, points = [(6, 8), (3, 4)], [2, 3]
    value, loc, attn = _inputs(shapes, points)
    with pytest.raises(ValueError, match="level_start"):
        msda_fwd_plain(torch.from_numpy(value), shapes, (0, 40), torch.from_numpy(loc),
                       torch.from_numpy(attn), points)
