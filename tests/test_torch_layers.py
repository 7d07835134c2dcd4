"""Each building block of custom_d_fine_tpu_torch/models/layers.py against its
flax counterpart in custom_d_fine_tpu/models/layers.py: the same numpy-seeded
inputs and the same weights (carried by utils/weights.py:flax_to_torch),
eval mode, held at rtol=atol=1e-5 (f32 on both sides; only summation order
differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.deploy.reparam import fuse_vgg_variables
from custom_d_fine_tpu.models import layers as fl
from custom_d_fine_tpu_torch.deploy.reparam import fuse_vgg_block
from custom_d_fine_tpu_torch.models import layers as tl
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _perturb(tree, rng):
    """Non-trivial norm scales/biases, LAB scalars and BN statistics."""
    def walk(t, key=""):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        if key == "var":
            return a + rng.uniform(0.2, 0.8, a.shape).astype(np.float32)
        if key in ("scale", "bias", "mean"):
            return a + rng.normal(0, 0.2, a.shape).astype(np.float32)
        return a
    return walk(tree)


def _pair(flax_mod, torch_mod, inputs, prefix, nchw=True, rng_seed=0):
    """Init flax, perturb, carry the weights over, run both on `inputs`."""
    rng = np.random.default_rng(rng_seed)
    jin = [jnp.asarray(x) for x in inputs]
    v = flax_mod.init(jax.random.PRNGKey(rng_seed), *jin)
    v = {k: _perturb(val, rng) for k, val in v.items()}
    want = np.asarray(flax_mod.apply(v, *jin))
    torch_mod.load_state_dict(flax_to_torch(v["params"], v.get("batch_stats", {}), prefix))
    torch_mod.eval()
    if nchw:
        tin = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in inputs]
        got = torch_mod(*tin).permute(0, 2, 3, 1)
    else:
        got = torch_mod(*[torch.from_numpy(x) for x in inputs])
    return got.detach().numpy(), want, v


def _img(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", ["silu", "relu", "leaky_relu", "gelu", "hardsigmoid",
                                  "identity", None])
def test_get_activation(name):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    want = np.asarray(fl.get_activation(name)(jnp.asarray(x)))
    got = tl.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_batchnorm_eval():
    got, want, _ = _pair(fl.BatchNorm(), tl.BatchNorm(6), [_img((2, 5, 7, 6))],
                         "encoder/input_proj_0_norm")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("frozen", [False, True])
def test_batchnorm_train(frozen):
    """Train mode: the output, its gradient and the running statistics after
    one update, on a 5x5 map at batch 2 (N = 50 values per channel), where
    flax's biased running variance and nn.BatchNorm2d's unbiased one differ
    by 2%. frozen keeps the running statistics and normalises with them."""
    x = _img((2, 5, 5, 6), seed=3) * 2.0 + 0.5
    cot = _img((2, 5, 5, 6), seed=4)
    mod = fl.BatchNorm(frozen=frozen)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {k: _perturb(val, np.random.default_rng(0)) for k, val in v.items()}

    def f(params, xin):
        y, upd = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, xin,
                           train=True, mutable=["batch_stats"])
        return (y * cot).sum(), (y, upd["batch_stats"])

    (_, (want, stats)), gx = jax.value_and_grad(f, argnums=1, has_aux=True)(
        v["params"], jnp.asarray(x))
    bn = tl.BatchNorm(6)
    bn.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], "encoder/input_proj_0_norm"))
    bn.frozen = frozen
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = bn(xt)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), **TOL)
    want_sd = flax_to_torch(v["params"], stats, "encoder/input_proj_0_norm")
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), want_sd[k].numpy(), **TOL, err_msg=k)


def test_learnable_affine_block():
    got, want, _ = _pair(fl.LearnableAffineBlock(), tl.LearnableAffineBlock(),
                         [_img((2, 3, 4, 5))], "backbone/stem/stem1/lab")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout,k,stride,groups,padding,use_act,use_lab", [
    (3, 8, 3, 2, 1, "", True, True),       # stem1-like, LAB
    (8, 4, 2, 1, 1, "", True, False),      # stem2a-like 2x2 valid
    (8, 8, 3, 2, 8, "", False, True),      # depthwise downsample, no act
    (6, 8, 2, 1, 1, "same2", True, True),  # torch ZeroPad2d([0,1,0,1]) form
    (8, 12, 1, 1, 1, "", True, True),      # 1x1 aggregation
])
def test_conv_bn_act(cin, cout, k, stride, groups, padding, use_act, use_lab):
    got, want, _ = _pair(
        fl.ConvBNAct(cout, k, stride=stride, groups=groups, padding=padding,
                     use_act=use_act, use_lab=use_lab),
        tl.ConvBNAct(cin, cout, k, stride=stride, groups=groups, padding=padding,
                     use_act=use_act, use_lab=use_lab),
        [_img((2, 9, 11, cin))], "backbone/stages_0/blocks_0/layers_0")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_light_conv_bn_act():
    got, want, _ = _pair(fl.LightConvBNAct(12, 5, use_lab=True),
                         tl.LightConvBNAct(8, 12, 5, use_lab=True),
                         [_img((2, 10, 10, 8))], "backbone/stages_2/blocks_0/layers_0")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,stride,groups,act", [(1, 1, 1, None), (3, 1, 1, "silu"),
                                                 (3, 2, 8, None)])
def test_conv_norm(k, stride, groups, act):
    got, want, _ = _pair(fl.ConvNorm(8, k, stride, groups=groups, act=act),
                         tl.ConvNorm(8, 8, k, stride, groups=groups, act=act),
                         [_img((2, 9, 9, 8))], "encoder/lateral_convs_0")
    np.testing.assert_allclose(got, want, **TOL)


def test_scdown():
    got, want, _ = _pair(fl.SCDown(8, 3, 2), tl.SCDown(6, 8, 3, 2),
                         [_img((2, 10, 10, 6))], "encoder/downsample_convs_0")
    np.testing.assert_allclose(got, want, **TOL)


def test_vgg_block_two_branch_and_deploy():
    x = _img((2, 8, 8, 6))
    got, want, v = _pair(fl.VGGBlock(6), tl.VGGBlock(6, 6),
                         [x], "encoder/fpn_blocks_0/cv2_csp/bottlenecks_0")
    np.testing.assert_allclose(got, want, **TOL)

    # deploy: the JAX reparam on flax variables vs the port's reparam on torch
    fused, n = fuse_vgg_variables({"params": v["params"], "batch_stats": v["batch_stats"]})
    assert n == 1
    want_d = np.asarray(fl.VGGBlock(6, deploy=True).apply(
        {"params": fused["params"]}, jnp.asarray(x)))
    np.testing.assert_allclose(want_d, want, rtol=1e-4, atol=1e-4)  # reparam rounding
    tb = tl.VGGBlock(6, 6)
    tb.load_state_dict(flax_to_torch(v["params"], v["batch_stats"],
                                     "encoder/fpn_blocks_0/cv2_csp/bottlenecks_0"))
    fuse_vgg_block(tb)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(tb(xt).permute(0, 2, 3, 1).detach().numpy(), want_d, **TOL)
    # the flax deploy tree (`fused`) also loads straight into a deploy block
    td = tl.VGGBlock(6, 6, deploy=True)
    td.load_state_dict(flax_to_torch(fused["params"], {},
                                     "encoder/fpn_blocks_0/cv2_csp/bottlenecks_0"))
    np.testing.assert_allclose(td(xt).permute(0, 2, 3, 1).detach().numpy(), want_d, **TOL)


@pytest.mark.parametrize("expansion", [1.0, 0.5])
def test_csp_layer(expansion):
    got, want, _ = _pair(fl.CSPLayer(8, 2, expansion=expansion),
                         tl.CSPLayer(6, 8, 2, expansion=expansion),
                         [_img((2, 7, 7, 6))], "encoder/fpn_blocks_0/cv2_csp")
    np.testing.assert_allclose(got, want, **TOL)


def test_rep_ncsp_elan4():
    got, want, _ = _pair(fl.RepNCSPELAN4(16, 16, 6, 2), tl.RepNCSPELAN4(12, 16, 16, 6, 2),
                         [_img((2, 6, 6, 12))], "encoder/pan_blocks_0")
    np.testing.assert_allclose(got, want, **TOL)


def test_mlp():
    got, want, _ = _pair(fl.MLP(16, 4, 3), tl.MLP(8, 16, 4, 3), [_img((2, 5, 8))],
                         "decoder/enc_bbox_head", nchw=False)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(masked):
    q, k, v = _img((2, 5, 16), 1), _img((2, 7, 16), 2), _img((2, 7, 16), 3)
    inputs = [q, k, v]
    if masked:
        mask = np.zeros((5, 7), bool)
        mask[:, 5:] = True
        mask[0, :2] = True
        inputs.append(mask)
    got, want, _ = _pair(fl.MultiHeadAttention(16, 4), tl.MultiHeadAttention(16, 4), inputs,
                         "decoder/decoder_layers_0/self_attn", nchw=False)
    np.testing.assert_allclose(got, want, **TOL)


def test_bias_init_with_prob():
    assert tl.bias_init_with_prob(0.01) == fl.bias_init_with_prob(0.01)
