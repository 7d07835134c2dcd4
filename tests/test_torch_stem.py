"""The port's stem (custom_d_fine_tpu_torch/ops/stem.py) on uint8 input
against the flax StemBlock and the TPU kernel fused_stem in interpret mode,
with the same weights. On the CPU stem_fwd takes its plain version (the CUDA
kernel is held against that version on the card by chip_smoke.py).

Tolerance atol 2e-5, as tests/test_stem_kernel.py:40: the 1/255 fold into
w1 rounds differently from x/255 followed by the conv.

The fast mode (bf16 conv operands, f32 sums) against the flax StemBlock in
f32 and against fused_stem(fast=True) in interpret mode: FAST_TOL of the
output's largest entry. Measured on these geometries: 5.1e-3 to 6.9e-3
against the flax StemBlock, 6.2e-3 to 7.6e-3 against fused_stem (which on
the CPU rounds at fewer places than its TPU passes do)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.models.hgnetv2 import StemBlock as FlaxStemBlock
from custom_d_fine_tpu.ops.pallas.stem import fold_stem_weights as jax_fold
from custom_d_fine_tpu.ops.pallas.stem import fused_stem
from custom_d_fine_tpu_torch.models.hgnetv2 import StemBlock
from custom_d_fine_tpu_torch.ops.stem import (fold_stem_weights, pack_fast_weights, stem_fwd,
                                              stem_fwd_plain)
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

ATOL = 2e-5
FAST_TOL = 1e-2


def _randomized(v, seed):
    rng = np.random.default_rng(seed)

    def walk(t, key=""):
        if hasattr(t, "items"):
            return {k: walk(val, k) for k, val in t.items()}
        a = np.asarray(t, np.float32)
        if key in ("mean", "var"):
            return a + rng.uniform(0, 0.3, a.shape).astype(np.float32)
        if key in ("scale", "bias"):  # BN affine and LAB scalars
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a
    return {k: walk(val) for k, val in v.items()}


def _both(use_lab, M, O, hw):
    """The same random StemBlock in both packages and a uint8 batch of 2:
    (x f32 for JAX, x uint8 for the port, flax variables, the flax output,
    the port's StemBlock)."""
    fm = FlaxStemBlock(M, O, use_lab=use_lab)
    rng = np.random.default_rng(0)
    x_u8 = rng.integers(0, 256, (2, *hw, 3)).astype(np.uint8)
    x = jnp.asarray(x_u8, jnp.float32)
    v = _randomized(jax.jit(lambda a: fm.init(jax.random.PRNGKey(0), a))(x / 255.0), 2)
    want = np.asarray(jax.jit(lambda a: fm.apply(v, a))(x / 255.0))
    stem = StemBlock(3, M, O, use_lab=use_lab).eval()
    stem.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], "backbone/stem"))
    return x, torch.from_numpy(x_u8), v, want, stem


@pytest.mark.parametrize("use_lab,M,O,hw", [
    (False, 24, 32, (64, 96)),   # geometries of tests/test_stem_kernel.py:24-29
    (True, 16, 16, (96, 64)),
    (False, 32, 48, (32, 32)),
    (False, 24, 32, (128, 64)),
    (True, 24, 32, (36, 44)),    # H % 32 != 0, H % 4 == 0: the port's kernel takes it
    (True, 32, 64, (32, 40)),    # the B5 stem's widths (D-FINE-x)
    (False, 48, 96, (32, 32)),   # the B6 stem's widths
])
def test_stem_matches_flax_and_interpret_kernel(use_lab, M, O, hw):
    x, xt, v, want, stem = _both(use_lab, M, O, hw)
    fw = fold_stem_weights(stem)
    launches = stem_fwd.launches
    got = stem_fwd(xt, fw).numpy()
    assert stem_fwd.launches == launches  # CPU tensors take the plain version
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, O)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, stem_fwd_plain(xt, fw).numpy())
    # the port's StemBlock module on x/255 is the flax StemBlock too
    with torch.no_grad():
        mod = stem(xt.permute(0, 3, 1, 2).float() / 255.0).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(mod, want, atol=ATOL)

    if hw[0] % 32 == 0:  # the TPU kernel's own geometry rule (stem.py:284)
        ref = np.asarray(fused_stem(x, jax_fold(v["params"], v["batch_stats"]),
                                    interpret=True))
        np.testing.assert_allclose(got, ref, atol=ATOL)


def test_fold_carries_lab_and_scaled_w1():
    stem = StemBlock(3, 16, 16, use_lab=True).eval()
    with torch.no_grad():
        stem.stem3.lab.scale.fill_(1.5)
        stem.stem3.lab.bias.fill_(-0.25)
    fw = fold_stem_weights(stem)
    assert fw["lab"].tolist()[3] == [1.5, -0.25]
    assert fw["lab"].tolist()[0] == [1.0, 0.0]
    t = stem.stem1.bn.weight / torch.sqrt(stem.stem1.bn.running_var + 1e-5)
    w = (stem.stem1.conv.weight * t[:, None, None, None]).permute(2, 3, 1, 0) / 255.0
    torch.testing.assert_close(fw["w1"], w.detach())
    assert fw["w3"].shape == (3, 3, 32, 16) and fw["w4"].shape == (1, 1, 16, 16)


@pytest.mark.parametrize("use_lab,M,O,hw", [
    (False, 24, 32, (64, 96)),
    (True, 16, 16, (96, 64)),
])
def test_stem_fast_matches_flax_and_interpret_kernel(use_lab, M, O, hw):
    """stem_fwd(fast=True) on the CPU is the plain fast version: within
    FAST_TOL (scaled) of the flax StemBlock and of fused_stem(fast=True), and
    not equal to the exact result, so the bf16 rounding does happen."""
    x, xt, v, want, stem = _both(use_lab, M, O, hw)
    fw = fold_stem_weights(stem)
    launches = (stem_fwd.launches, stem_fwd.fast_launches)
    got = stem_fwd(xt, fw, fast=True).numpy()
    assert (stem_fwd.launches, stem_fwd.fast_launches) == launches
    np.testing.assert_array_equal(got, stem_fwd_plain(xt, fw, fast=True).numpy())
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= FAST_TOL * scale
    ref = np.asarray(fused_stem(x, jax_fold(v["params"], v["batch_stats"]), fast=True,
                                interpret=True))
    assert np.abs(got - ref).max() <= FAST_TOL * scale
    exact = stem_fwd_plain(xt, fw).numpy()
    assert np.abs(got - exact).max() > 1e-3 * scale  # measured 5.1e-3 and 6.9e-3


def test_fast_weights_fragment_order():
    """pack_fast_weights holds each conv as mma.m16n8k16 B fragments: for
    8-column tile j, 16-deep step s and lane g*4+t, the four bf16 values
    (k = 16s + 2t, 2t+1, 2t+8, 2t+9; n = 8j+g). Unpacking by that rule gives
    back [taps x Cin, Cout] of each conv in bf16, zero-padded."""
    M, M2, O = 24, 12, 32
    fw = fold_stem_weights(StemBlock(3, M, O, use_lab=True).eval())
    packed = pack_fast_weights(fw).float()
    M2p = 16
    w2a = torch.zeros(4 * M, M2p)
    w2a[:, :M2] = fw["w2a"].reshape(4 * M, M2)
    w2b = torch.zeros(2, 2, M2p, M)
    w2b[:, :, :M2] = fw["w2b"]
    want = [fw["w1"].reshape(27, M), w2a, w2b.reshape(4 * M2p, M),
            fw["w3"].reshape(18 * M, M), fw["w4"].reshape(M, O)]
    off = 0
    for w in want:
        K, N = w.shape
        Kp = -(-K // 16) * 16
        frag = packed[off:off + N * Kp].reshape(N // 8, Kp // 16, 8, 4, 4)  # j, s, g, t, reg
        got = torch.zeros(Kp, N)
        for r, dk in enumerate((0, 1, 8, 9)):
            k = (torch.arange(Kp // 16)[:, None, None] * 16 + 2 * torch.arange(4) + dk)
            n = torch.arange(N // 8)[:, None] * 8 + torch.arange(8)
            got[k[None].expand(N // 8, -1, 8, -1), n[:, None, :, None].expand(
                -1, Kp // 16, -1, 4)] = frag[..., r]
        torch.testing.assert_close(got[:K], w.to(torch.bfloat16).float(), rtol=0, atol=0)
        assert float(got[K:].abs().sum()) == 0.0
        off += N * Kp
    assert off == packed.numel()
