"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes that reach the edge cases (H % 32 != 0, c < 32 and c > 32,
ragged tiles), plus the wrappers' input checks. Marked `cuda`: each test
skips where no GPU is present. This file imports no JAX, so it also runs on
a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from custom_d_fine_tpu_torch.models.hgnetv2 import StemBlock
from custom_d_fine_tpu_torch.ops.msda import (level_start_index, msda, msda_bwd, msda_bwd_plain,
                                              msda_fwd, msda_fwd_plain)
from custom_d_fine_tpu_torch.ops.stem import fold_stem_weights, stem_fwd, stem_fwd_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stem(M, O, use_lab, seed=0):
    g = torch.Generator().manual_seed(seed)
    stem = StemBlock(3, M, O, use_lab=use_lab).eval()
    with torch.no_grad():
        for m in stem.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return stem


@pytest.mark.parametrize("M,O,use_lab,hw", [
    (24, 32, True, (64, 96)),
    (16, 16, False, (36, 44)),   # H % 32 != 0; ragged 8x8 output tiles
    (32, 48, True, (32, 32)),
])
def test_stem_kernel_matches_plain(dev, M, O, use_lab, hw):
    fw = fold_stem_weights(_stem(M, O, use_lab).to(dev))
    x = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, device=dev)
    n = stem_fwd.launches
    got = stem_fwd(x, fw)
    torch.cuda.synchronize()
    assert stem_fwd.launches == n + 1
    torch.testing.assert_close(got, stem_fwd_plain(x, fw), rtol=0, atol=2e-5)


@pytest.mark.parametrize("c", [8, 32, 64])
def test_msda_kernel_matches_plain(dev, c):
    shapes, points = [(12, 16), (6, 8), (3, 4)], [2, 3, 1]
    g = torch.Generator().manual_seed(c)
    B, Lq, nh = 2, 37, 3
    Lv, P = sum(h * w for h, w in shapes), sum(points)
    value = torch.randn(B, Lv, nh, c, generator=g).to(dev)
    loc = (torch.rand(B, Lq, nh, P, 2, generator=g) * 1.4 - 0.2).to(dev)
    loc[0, 0, 0, 0] = torch.tensor([1.0, 0.0])
    loc[1, 1, 1, 1] = torch.tensor([-5.0, 9.0])
    attn = torch.rand(B, Lq, nh, P, generator=g).to(dev)
    starts = level_start_index(shapes)
    for v in (value, value.to(torch.bfloat16)):
        n = msda_fwd.launches
        got = msda_fwd(v, shapes, starts, loc, attn, points)
        torch.cuda.synchronize()
        assert msda_fwd.launches == n + 1 and got.dtype == torch.float32
        torch.testing.assert_close(got, msda_fwd_plain(v, shapes, starts, loc, attn, points),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [8, 32, 64])
def test_msda_bwd_kernel_matches_plain(dev, c):
    """dloc and dattn are warp sums in f32 (rtol 1e-4, atol 1e-5); dvalue is
    summed with f32 atomics in an order that changes from run to run: f32 at
    rtol 1e-4, atol 1e-5, and a bf16 dvalue within one bf16 rounding (1e-2)."""
    shapes, points = [(12, 16), (6, 8), (3, 4)], [2, 3, 1]
    g = torch.Generator().manual_seed(100 + c)
    B, Lq, nh = 2, 37, 3
    Lv, P = sum(h * w for h, w in shapes), sum(points)
    value = torch.randn(B, Lv, nh, c, generator=g).to(dev)
    loc = (torch.rand(B, Lq, nh, P, 2, generator=g) * 1.4 - 0.2).to(dev)
    loc[0, 0, 0, 0] = torch.tensor([1.0, 0.0])
    loc[1, 1, 1, 1] = torch.tensor([-5.0, 9.0])   # no corner inside: zero gradient
    attn = torch.rand(B, Lq, nh, P, generator=g).to(dev)
    grad = torch.randn(B, Lq, nh * c, generator=g).to(dev)
    starts = level_start_index(shapes)
    for v in (value, value.to(torch.bfloat16)):
        n = msda_bwd.launches
        got = msda_bwd(v, shapes, starts, loc, attn, grad, points)
        torch.cuda.synchronize()
        assert msda_bwd.launches == n + 1
        want = msda_bwd_plain(v, shapes, starts, loc, attn, grad, points)
        assert got[0].dtype == v.dtype and got[1].dtype == got[2].dtype == torch.float32
        dv_tol = dict(rtol=1e-4, atol=1e-5) if v.dtype == torch.float32 else \
            dict(rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(got[0].float(), want[0].float(), **dv_tol)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert float(got[1][1, 1, 1, 1].abs().sum()) == 0.0 and float(got[2][1, 1, 1, 1]) == 0.0


def test_msda_function_launches_both_kernels(dev):
    shapes, points = [(8, 8), (4, 4)], [2, 2]
    g = torch.Generator().manual_seed(5)
    value = torch.randn(2, 80, 2, 32, generator=g).to(dev).requires_grad_()
    loc = torch.rand(2, 7, 2, 4, 2, generator=g).to(dev).requires_grad_()
    attn = torch.rand(2, 7, 2, 4, generator=g).to(dev).requires_grad_()
    n = (msda_fwd.launches, msda_bwd.launches)
    msda(value, shapes, loc, attn, points).square().sum().backward()
    torch.cuda.synchronize()
    assert (msda_fwd.launches, msda_bwd.launches) == (n[0] + 1, n[1] + 1)
    assert value.grad is not None and loc.grad is not None and attn.grad is not None


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    shapes, points = [(4, 4)], [2]
    value = torch.randn(1, 16, 2, 8, device=dev)
    loc = torch.rand(1, 3, 2, 2, 2, device=dev)
    attn = torch.rand(1, 3, 2, 2, device=dev)
    with pytest.raises(ValueError):
        msda_fwd(value.half(), shapes, (0,), loc, attn, points)
    with pytest.raises(ValueError):
        msda_fwd(value, shapes, (0,), loc.transpose(1, 2), attn, points)
    with pytest.raises(ValueError):
        msda_fwd(value, [(4, 5)], (0,), loc, attn, points)
    fw = fold_stem_weights(_stem(16, 16, False).to(dev))
    with pytest.raises(ValueError):
        stem_fwd(torch.zeros(1, 34, 32, 3, dtype=torch.uint8, device=dev), fw)
    with pytest.raises(ValueError):
        stem_fwd(torch.zeros(1, 32, 32, 3, device=dev), fw)
    grad = torch.randn(1, 3, 16, device=dev)
    with pytest.raises(ValueError):
        msda_bwd(value, shapes, (0,), loc, attn, grad.double(), points)
    with pytest.raises(ValueError):
        msda_bwd(value, shapes, (0,), loc, attn, grad[:, :2], points)
