"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes that reach the edge cases (H % 32 != 0, c < 32 and c > 32,
c not a multiple of 16 bytes, more channel groups than a warp has lanes,
more than 32 MSDA points, an unaligned value map, ragged tiles, levels
larger than one shared-memory slab of msda_bwd), plus the wrappers' input
checks. Marked `cuda`: each test
skips where no GPU is present. This file imports no JAX, so it also runs on
a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import functools
import socket

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


@pytest.mark.parametrize("M,O,use_lab,hw,B", [
    (24, 32, True, (64, 96), 2),
    (16, 16, False, (36, 44), 2),    # H % 32 != 0; ragged 10x10 output tiles
    (32, 48, True, (32, 32), 2),
    (32, 64, True, (40, 48), 2),     # the B5 stem's widths
    (48, 96, False, (32, 32), 2),    # the B6 stem's widths (one CTA an SM)
    (24, 32, False, (52, 84), 3),    # 13x21 outputs: ragged tiles in both directions
    (24, 32, True, (640, 640), 16),  # D-FINE-m's stem at bs16 640^2
    (8, 4, True, (44, 40), 1),       # convs with fewer outputs than a group: groups of 4
])
def test_stem_kernel_matches_plain(dev, M, O, use_lab, hw, B):
    fw = fold_stem_weights(_stem(M, O, use_lab).to(dev))
    x = torch.randint(0, 256, (B, *hw, 3), dtype=torch.uint8, device=dev)
    n = stem_fwd.launches
    got = stem_fwd(x, fw)
    torch.cuda.synchronize()
    assert stem_fwd.launches == n + 1
    torch.testing.assert_close(got, stem_fwd_plain(x, fw), rtol=0, atol=2e-5)


_LEVELS3 = ([(12, 16), (6, 8), (3, 4)], [2, 3, 1])
_LEVELS4 = ([(12, 16), (6, 8), (3, 4), (2, 2)], [12, 12, 8, 4])  # 36 points an item


def _msda_inputs(g, shapes, points, B, Lq, nh, c):
    Lv, P = sum(h * w for h, w in shapes), sum(points)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Lq, nh, P, 2, generator=g) * 1.4 - 0.2
    loc[0, 0, 0, 0] = torch.tensor([1.0, 0.0])
    loc[1, 1, 1, 1] = torch.tensor([-5.0, 9.0])
    attn = torch.rand(B, Lq, nh, P, generator=g)
    return value, loc, attn


@pytest.mark.parametrize("c,levels", [
    (6, _LEVELS3),    # c % 4 != 0: one channel a lane, in f32 and bf16
    (8, _LEVELS3),    # bf16: one 16-byte lane an item row, four items a warp
    (32, _LEVELS3),
    (64, _LEVELS3),
    (32, _LEVELS4),   # more than 32 points: prepared 32 at a time
    (6, _LEVELS4),
    (36, _LEVELS3),   # bf16: one channel a lane, 36 groups: two passes of the warp
    (160, _LEVELS3),  # f32: 40 groups of 4 channels: two passes of the warp
])
def test_msda_kernel_matches_plain(dev, c, levels):
    shapes, points = levels
    g = torch.Generator().manual_seed(c)
    value, loc, attn = (t.to(dev) for t in _msda_inputs(g, shapes, points, 2, 37, 3, c))
    starts = level_start_index(shapes)
    for v in (value, value.to(torch.bfloat16)):
        n = msda_fwd.launches
        got = msda_fwd(v, shapes, starts, loc, attn, points)
        torch.cuda.synchronize()
        assert msda_fwd.launches == n + 1 and got.dtype == torch.float32
        torch.testing.assert_close(got, msda_fwd_plain(v, shapes, starts, loc, attn, points),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [32, 64])  # 64: two passes of the warp over the channels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_kernel_unaligned_value(dev, dtype, c):
    """A value map that is contiguous but starts one element past a 16-byte
    boundary takes the one-channel-a-lane path and gives the plain result."""
    shapes, points = _LEVELS3
    g = torch.Generator().manual_seed(11)
    value, loc, attn = (t.to(dev) for t in _msda_inputs(g, shapes, points, 2, 37, 3, c))
    buf = torch.empty(value.numel() + 1, dtype=dtype, device=dev)
    shifted = buf[1:].view(value.shape)
    shifted.copy_(value)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    starts = level_start_index(shapes)
    got = msda_fwd(shifted, shapes, starts, loc, attn, points)
    torch.cuda.synchronize()
    want = msda_fwd_plain(shifted, shapes, starts, loc, attn, points)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    aligned = msda_fwd(value.to(dtype), shapes, starts, loc, attn, points)
    torch.testing.assert_close(got, aligned, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [6, 8, 32, 64])  # 6: the scalar paths (no 16-byte rows)
def test_msda_bwd_kernel_matches_plain(dev, c):
    """dloc and dattn are warp sums in f32 (rtol 1e-4, atol 1e-5); dvalue is
    summed with shared-memory f32 atomics in an order that changes from run
    to run: f32 at rtol 1e-4, atol 1e-5, and a bf16 dvalue within one bf16
    rounding (1e-2)."""
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


@pytest.mark.parametrize("M,O,use_lab,hw", [
    (24, 32, True, (64, 96)),
    (16, 16, False, (36, 44)),   # H % 32 != 0; ragged 8x8 output tiles
    (32, 48, True, (32, 32)),
    (48, 96, True, (40, 72)),    # the B6 stem (M2 = 24)
])
def test_stem_fast_kernel_matches_plain(dev, M, O, use_lab, hw):
    """The tensor-core kernel against the plain fast version (bf16 operands,
    f32 sums) at 1e-2 of the output's largest entry: a bf16 intermediate may
    round the other way when its f32 sum is taken in another order."""
    fw = fold_stem_weights(_stem(M, O, use_lab).to(dev))
    x = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, device=dev)
    n = (stem_fwd.launches, stem_fwd.fast_launches)
    got = stem_fwd(x, fw, fast=True)
    torch.cuda.synchronize()
    assert (stem_fwd.launches, stem_fwd.fast_launches) == (n[0] + 1, n[1] + 1)
    want = stem_fwd_plain(x, fw, fast=True)
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, O)
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def _edge_points(g, shapes, points, B, Lq, nh, c):
    """MSDA inputs whose points lie across the band and rectangle edges of
    msda_bwd's shared-memory slabs (SLAB_FLOATS = 25,600 f32 per CTA, at
    most 256 channels) and outside the map."""
    npos = 25600 // min(c, 256)
    P = sum(points)
    loc = torch.rand(B, Lq, nh, P, 2, generator=g) * 1.4 - 0.2
    p0 = 0
    for (H, W), p in zip(shapes, points):
        tw = min(W, npos)
        th = min(H, npos // tw)
        # corners (x0, x0 + 1) on both sides of a rectangle's right edge and
        # (y0, y0 + 1) on both sides of a band's lower edge
        ex = min(tw, W - 1) / W if tw < W else 0.5
        ey = min(th, H - 1) / H if th < H else 0.5
        loc[:, : Lq // 2, :, p0, 0] = ex
        loc[:, : Lq // 2, :, p0, 1] = ey
        p0 += p
    loc[0, 0, 0, 0] = torch.tensor([-3.0, 0.5])  # far outside: zero gradient
    return loc


@pytest.mark.parametrize("c,shapes", [
    (16, [(64, 50), (2, 1700)]),   # 1600-position slabs: bands of 32 rows; rows wider
    (64, [(30, 30), (2, 450)]),    # 400-position slabs: bands of 13 rows; rows wider
])
def test_msda_bwd_across_slab_edges(dev, c, shapes):
    """dvalue summed per shared-memory slab: levels larger than one slab
    (bands of rows, and rows wider than a slab), points on the edges. f32:
    rtol 1e-4, atol 1e-5; a bf16 dvalue within one bf16 rounding."""
    points = [3, 2]
    g = torch.Generator().manual_seed(200 + c)
    B, Lq, nh = 2, 40, 2
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g).to(dev)
    loc = _edge_points(g, shapes, points, B, Lq, nh, c).to(dev)
    attn = torch.rand(B, Lq, nh, sum(points), generator=g).to(dev)
    grad = torch.randn(B, Lq, nh * c, generator=g).to(dev)
    starts = level_start_index(shapes)
    for v in (value, value.to(torch.bfloat16)):
        got = msda_bwd(v, shapes, starts, loc, attn, grad, points)
        torch.cuda.synchronize()
        want = msda_bwd_plain(v, shapes, starts, loc, attn, grad, points)
        assert got[0].dtype == v.dtype
        dv_tol = dict(rtol=1e-4, atol=1e-5) if v.dtype == torch.float32 else \
            dict(rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(got[0].float(), want[0].float(), **dv_tol)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert float(got[1][0, 0, 0, 0].abs().sum()) == 0.0


def test_msda_bwd_dvalue_is_zero_where_no_point_samples(dev):
    """The wrapper allocates dvalue with torch.empty; the kernel writes every
    element. Memory the allocator hands back is first filled with NaN, and
    all points sample the top-left corner of each map: dvalue must be exactly
    0 everywhere else."""
    shapes, points = [(40, 40), (20, 20)], [2, 2]
    B, Lq, nh, c = 2, 30, 2, 32
    Lv = sum(h * w for h, w in shapes)
    junk = torch.full((4 * B * Lv * nh * c,), float("nan"), device=dev)
    del junk  # its block goes back to the caching allocator, NaN and all
    g = torch.Generator().manual_seed(7)
    value = torch.randn(B, Lv, nh, c, generator=g).to(dev)
    loc = (torch.rand(B, Lq, nh, 4, 2, generator=g) * 0.2).to(dev)  # x, y < 0.2
    attn = torch.rand(B, Lq, nh, 4, generator=g).to(dev)
    grad = torch.randn(B, Lq, nh * c, generator=g).to(dev)
    starts = level_start_index(shapes)
    for v in (value, value.to(torch.bfloat16)):
        dv = msda_bwd(v, shapes, starts, loc, attn, grad, points)[0].float()
        torch.cuda.synchronize()
        assert torch.isfinite(dv).all()
        for (H, W), s in zip(shapes, starts):
            m = dv[:, s:s + H * W].reshape(B, H, W, nh, c)
            yy = int(0.2 * H) + 1  # corners reach row floor(0.2 H - 0.5) + 1 at most
            xx = int(0.2 * W) + 1
            assert float(m[:, yy:].abs().sum()) == 0.0 and float(m[:, :, xx:].abs().sum()) == 0.0
            assert float(m[:, :yy, :xx].abs().sum()) > 0.0
        want = msda_bwd_plain(v, shapes, starts, loc, attn, grad, points)[0].float()
        torch.testing.assert_close(dv, want, rtol=1e-2, atol=1e-2)


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
    with pytest.raises(ValueError):  # fast mode needs the bf16 fragments
        stem_fwd(torch.zeros(1, 32, 32, 3, dtype=torch.uint8, device=dev),
                 {k: v for k, v in fw.items() if k != "wtc"}, fast=True)
    grad = torch.randn(1, 3, 16, device=dev)
    with pytest.raises(ValueError):
        msda_bwd(value, shapes, (0,), loc, attn, grad.double(), points)
    with pytest.raises(ValueError):
        msda_bwd(value, shapes, (0,), loc, attn, grad[:, :2], points)


def test_synced_batch_norm_at_world_size_1_matches_unsynced(dev):
    """The Trainer's data-parallel BatchNorm (models/layers.py
    synced_batch_norm: one all_reduce of count, sum and sum of squares) in a
    process group of world size 1 on NCCL, against BatchNorm's own train-mode
    forward on the same input: output, input gradient and running statistics
    at rtol=atol=1e-5 (E[x^2]-E[x]^2 rounds otherwise than the cuDNN kernel)."""
    from custom_d_fine_tpu_torch.models.layers import BatchNorm, synced_batch_norm

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                         world_size=1, rank=0)
    try:
        g = torch.Generator().manual_seed(8)
        x = (torch.randn(4, 24, 20, 20, generator=g) * 2 + 0.5).to(dev)
        w = torch.randn(4, 24, 20, 20, generator=g).to(dev)
        bn = BatchNorm(24).to(dev).train()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(24, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(24, generator=g))
        other = copy.deepcopy(bn)
        out = []
        for fn, mod in ((lambda m, t: m(t), bn), (synced_batch_norm, other)):
            xr = x.clone().requires_grad_()
            y = fn(mod, xr)
            (y * w).sum().backward()
            out.append((y.detach(), xr.grad, mod.running_mean, mod.running_var))
        for a, b in zip(*out):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        assert int(other.num_batches_tracked) == int(bn.num_batches_tracked) == 1
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("bf16", [False, True])
def test_eval_step_matches_the_cpu_copy(dev, bf16):
    """train_step.make_eval_step (the Trainer's eval: the EMA's weights,
    top-300) on the card against the same on a CPU copy: registry size s,
    2 images of 320x320, conv kernels x sqrt(6) so that query selection does
    not tie, the model's own weights moved away from the EMA's. f32 (TF32
    off): scores at atol 1e-4, labels and boxes (atol 1e-4 x 320 pixels)
    where a score stands 1e-4 from its neighbours. bf16 autocast with a bf16
    MSDA value map, as the Trainer evaluates: scores at atol 2e-2."""
    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.models.dfine import build_model
    from custom_d_fine_tpu_torch.train.train_step import TrainState, make_eval_step

    model = build_model(get_model_config("s"), num_classes=80, seed=4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(6 ** 0.5)
    ema = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05)
    x = torch.randint(0, 256, (2, 320, 320, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(9))
    want = make_eval_step()(TrainState(copy.deepcopy(model), None, ema), x)
    dmodel = copy.deepcopy(model).to(dev)
    got = make_eval_step(bf16=bf16)(
        TrainState(dmodel, None, {k: v.to(dev) for k, v in ema.items()}), x.to(dev))
    got = {k: v.cpu() for k, v in got.items()}
    assert got["scores"].shape == (2, 300) and got["boxes"].dtype == torch.float32
    tol = 2e-2 if bf16 else 1e-4
    torch.testing.assert_close(got["scores"], want["scores"], rtol=0, atol=tol)
    if not bf16:
        for b in range(2):
            keep = torch.ones(300, dtype=torch.bool)
            for s in (got["scores"][b], want["scores"][b]):
                d = (s[1:] - s[:-1]).abs() > 1e-4
                keep[:-1] &= d
                keep[1:] &= d
            assert keep.sum() >= 5
            assert torch.equal(got["labels"][b][keep], want["labels"][b][keep])
            torch.testing.assert_close(got["boxes"][b][keep], want["boxes"][b][keep],
                                       rtol=0, atol=1e-4 * 320)



def test_segment_serving_matches_the_cpu_copy(dev):
    """The segment model's serving forward (registry size s with the mask
    head, 320x320, bs2) on the card against a CPU copy, all f32 (TF32 off,
    exact stem, f32 MSDA value): scores at atol 1e-4; labels, boxes (atol
    1e-4 x 320 pixels) and the top-K masks (probabilities, atol 1e-4) where
    a score stands 1e-4 from its neighbours. Conv kernels x sqrt(6) so that
    query selection does not tie."""
    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.deploy.reparam import convert_to_deploy
    from custom_d_fine_tpu_torch.deploy.serving import make_serving_forward
    from custom_d_fine_tpu_torch.models.dfine import build_model

    model = build_model(get_model_config("s", enable_mask_head=True), num_classes=80, seed=4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(6 ** 0.5)
    convert_to_deploy(model)
    x = torch.randint(0, 256, (2, 320, 320, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(9))
    want = make_serving_forward(copy.deepcopy(model), (320, 320))(x)
    got = make_serving_forward(copy.deepcopy(model).to(dev), (320, 320), msda_value_dtype=None,
                               stem_fast=False)(x.to(dev))
    got = {k: v.cpu() for k, v in got.items()}
    assert got["masks"].shape == (2, 300, 80, 80) and got["masks"].dtype == torch.float32
    torch.testing.assert_close(got["scores"], want["scores"], rtol=0, atol=1e-4)
    for b in range(2):
        keep = torch.ones(300, dtype=torch.bool)
        for s in (got["scores"][b], want["scores"][b]):
            d = (s[1:] - s[:-1]).abs() > 1e-4
            keep[:-1] &= d
            keep[1:] &= d
        assert keep.sum() >= 5
        assert torch.equal(got["labels"][b][keep], want["labels"][b][keep])
        torch.testing.assert_close(got["boxes"][b][keep], want["boxes"][b][keep], rtol=0,
                                   atol=1e-4 * 320)
        torch.testing.assert_close(got["masks"][b][keep], want["masks"][b][keep], rtol=0,
                                   atol=1e-4)


def test_discrete_sampling_card_matches_cpu(dev):
    """ms_deform_attn_discrete (cross_attn_method="discrete"; plain PyTorch,
    which is also what runs on the card) on identical inputs on the card and
    on the CPU, at D-FINE-m's serving shapes with 40 queries on pixel
    boundaries of level 0 (x * W + 0.5 an integer) and points outside the
    maps: the same pixel indices; the output at atol 1e-6 (sums of 12
    weighted values); the gradients of value and attention at rtol = atol =
    1e-5 (the attention's is a sum over 32 channels of products of N(0, 1)
    terms, so f32 sums in another order differ by up to ~32 * 2^-24 * 6);
    no gradient to the locations."""
    from custom_d_fine_tpu_torch.ops.deform_attn import discrete_index, ms_deform_attn_discrete

    g = torch.Generator().manual_seed(0)
    shapes, points, B, Lq, h, c = [(80, 80), (40, 40), (20, 20)], [3, 6, 3], 2, 300, 8, 32
    value = torch.randn(B, sum(H * W for H, W in shapes), h, c, generator=g)
    loc = torch.rand(B, Lq, h, 12, 2, generator=g) * 1.4 - 0.2
    loc[:, :40] = (torch.randint(0, 80, (B, 40, h, 12, 2), generator=g) + 0.5) / 80
    attn = torch.softmax(torch.randn(B, Lq, h, 12, generator=g), -1)
    grad = torch.randn(B, Lq, h * c, generator=g)
    res = []
    for d in ("cpu", dev):
        v, l, a = (t.clone().to(d).requires_grad_() for t in (value, loc, attn))
        out = ms_deform_attn_discrete(v, shapes, l, a, points)
        out.backward(grad.to(d))
        idx = [discrete_index(l.detach()[:, :, :, p0:p0 + P], H, W).cpu()
               for (H, W), p0, P in zip(shapes, (0, 3, 9), points)]
        assert l.grad is None
        res.append((idx, out.detach().cpu(), v.grad.cpu(), a.grad.cpu()))
    (i_cpu, *want), (i_dev, *got) = res
    for a, b in zip(i_cpu, i_dev):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_profiling_helpers_read_the_card(dev):
    """utils/profiling.py on a matmul: the profiler's device events and their
    busy time, by name, and a span around the matmul, which the profiler
    records on the host and whose annotation device_spans leaves out."""
    from custom_d_fine_tpu_torch.utils import profiling

    a = torch.randn(512, 512, device=dev)

    def matmul():
        with profiling.span("matmul"):
            return a @ a

    profiling.clear_spans()
    spans = profiling.device_spans(matmul, 3)
    assert len(spans) >= 3 and all(d > 0 for _, _, d in spans)
    assert "matmul" not in {n for n, _, _ in spans}
    assert 0 < profiling.busy_ms(spans) <= sum(d for _, _, d in spans) / 1e6
    assert [s.name for s in profiling.spans()] == ["matmul"] * 3
    profiling.clear_spans()
    ev = profiling.events_by_name(lambda: a @ a, n=2)
    assert ev and ev[0]["calls"] >= 1


# ------------------------------------------------- the training step's CUDA graphs

def _train_batches(dev, n, B, img, seed=5, max_gt=100, n_gt=12):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        b = {"images": torch.randint(0, 256, (B, img, img, 3), dtype=torch.uint8, generator=g),
             "labels": torch.randint(0, 80, (B, max_gt), generator=g),
             "boxes": torch.cat([torch.rand(B, max_gt, 2, generator=g) * 0.6 + 0.2,
                                 torch.rand(B, max_gt, 2, generator=g) * 0.25 + 0.05], -1),
             "valid": (torch.arange(max_gt) < n_gt)[None].expand(B, -1).contiguous()}
        out.append({k: v.to(dev) for k, v in b.items()})
    return out


def _step_parts(state, metrics):
    """What a training step leaves, by kind, on the host in f64."""
    adam = state.optimizer.adamw.state
    named = dict(state.model.named_parameters())

    def host(d):
        return {k: v.detach().double().cpu() for k, v in d.items()}

    return {"loss terms": host({k: v for k, v in metrics.items() if k != "grad_norm"}),
            "grad_norm": host({"grad_norm": metrics["grad_norm"]}),
            "gradients": host({k: p.grad for k, p in named.items() if p.grad is not None}),
            "BN buffers": host(dict(state.model.named_buffers())),
            "exp_avg": host({k: adam[p]["exp_avg"] for k, p in named.items() if p in adam}),
            "exp_avg_sq": host({k: adam[p]["exp_avg_sq"] for k, p in named.items()
                                if p in adam}),
            "EMA": host(state.ema),
            "parameters": host(named)}


def _gap(a, b) -> float:
    """||a - b|| / ||b|| over every tensor of two equal-keyed dicts together."""
    assert a.keys() == b.keys()
    num = sum(float(torch.linalg.vector_norm(a[k] - b[k])) ** 2 for k in b)
    den = sum(float(torch.linalg.vector_norm(b[k])) ** 2 for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def _counters(keys):
    return keys.replays, keys.captures, keys.eager


def test_graphed_training_steps_match_eager_steps(dev, monkeypatch):
    """train/graphs.py on D-FINE-m, bs4 640^2, bf16 autocast. 3 steps with the
    backbone and encoder replayed as CUDA graphs (the first captures them;
    the criterion's loss terms replay theirs too, and the eager steps run
    both eagerly),
    each against three eager steps from a copy of the same state, batch and
    denoising draws (conv kernels x sqrt(6), so that the query selection
    does not tie): one as the step runs, one on a side stream, one on a side
    stream with autocast's weight cache off, as a capture runs. Each gap
    (||graphed - eager|| / ||eager|| over all the tensors of one kind after
    the step: its loss terms, grad_norm, every gradient, the BN buffers,
    AdamW's moments, the EMA, the parameters) is bounded by twice the
    largest gap between the eager steps of any of the 3 (for grad_norm, one
    number, also by twice that of the gradients it is the norm of, which
    bounds it), or by 1e-6 where they agree exactly. That is the noise a
    graph brings: cuBLAS and cuDNN pick their algorithms per stream and
    workspace, and a weight cast once or per use sums its bf16 gradient
    otherwise. On the H100 the eager steps of one step agree to ~4e-7 at
    one step and differ by ~2.6e-2 at the next (the backbone's scalar
    affine parameters' gradients, the worst conditioned), grad_norm by up
    to 5e-4, whichever way they run; so one step's eager gap does not show
    the noise, and the largest over the 3 does.
    Step 1's BN buffers are bit-equal: warm-up and capture leave them as
    they found them. Then, on the graphed state: a forward hook on stages[1]
    fires on every replay and sees the replayed output (its static buffer,
    the same on every step); a hook inside stages[1] runs that unit eagerly
    (a new key, 5 units captured) and the front's counters say so; a second
    input shape captures its own graphs."""
    import math

    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.models.dfine import build_model
    from custom_d_fine_tpu_torch.train import graphs
    from custom_d_fine_tpu_torch.train.train_step import build_training

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults; autocast runs in bf16
    autocast = torch.autocast
    ref = build_model(get_model_config("m"), num_classes=80, seed=1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(math.sqrt(6.0))
    step, state = build_training("m", 80, seed=0, bf16=True, state_dict=ref.state_dict())
    eager_step, _ = build_training("m", 80, seed=0, bf16=True)
    front = step.graphs.front
    batches = _train_batches(dev, 5, 4, 640)
    gen = torch.Generator().manual_seed(3)
    gaps, noise = {}, {}  # by kind: graphed vs eager each step; the largest eager vs eager
    for i, b in enumerate(batches[:3]):
        drawn = gen.get_state()
        copies = [copy.deepcopy(state) for _ in range(3)]
        before = _counters(front)
        state, m = step(state, b, gen)
        got = _step_parts(state, m)
        assert tuple(a - c for a, c in zip(_counters(front), before)) == \
            ((6, 6, 0) if i == 0 else (6, 0, 0))
        monkeypatch.setattr(graphs, "MAX_KEYS", 0)  # the eager steps keep no key
        eager = []
        for e, side, cache in zip(copies, (False, True, True), (True, True, False)):
            gen.set_state(drawn)
            stream = torch.cuda.Stream() if side else torch.cuda.current_stream()
            stream.wait_stream(torch.cuda.current_stream())
            monkeypatch.setattr(torch, "autocast", functools.partial(autocast,
                                                                     cache_enabled=cache))
            with torch.cuda.stream(stream):
                e, m = eager_step(e, b, gen)
            torch.cuda.synchronize()
            eager.append(_step_parts(e, m))
        monkeypatch.undo()
        if i == 0:
            assert all(torch.equal(got["BN buffers"][k], eager[0]["BN buffers"][k])
                       for k in got["BN buffers"])
        for kind in got:
            gaps.setdefault(kind, []).append(_gap(got[kind], eager[0][kind]))
            noise[kind] = max([noise.get(kind, 0.0)] + [
                _gap(eager[j][kind], eager[k][kind]) for j, k in ((1, 0), (2, 0), (2, 1))])
        del copies, eager
    # the rounding of one number is one draw: grad_norm is held to that of
    # the gradients it is the norm of, which bounds it
    noise["grad_norm"] = max(noise["grad_norm"], noise["gradients"])
    for kind, per_step in gaps.items():
        print(f"{kind}: graphed vs eager {per_step}, eager vs eager {noise[kind]:.3e}")
        assert max(per_step) <= max(2.0 * noise[kind], 1e-6), (kind, per_step, noise[kind])

    stage1 = state.model.backbone.stages[1]
    seen = []
    h = stage1.register_forward_hook(
        lambda m, a, out: seen.append((out.data_ptr(), float(out.detach().float().sum()))))
    before = _counters(front)
    for b in batches[3:5]:
        state, _ = step(state, b, gen)
    h.remove()
    (chain,) = front.chains.values()
    static = chain.units[2].outputs[0]
    assert [p for p, _ in seen] == [static.data_ptr()] * 2
    assert all(math.isfinite(s) for _, s in seen)
    assert tuple(a - c for a, c in zip(_counters(front), before)) == (12, 0, 0)

    inner = stage1.blocks[0].register_forward_hook(lambda m, a, out: None)
    before = _counters(front)
    state, m = step(state, batches[0], gen)
    inner.remove()
    assert tuple(a - c for a, c in zip(_counters(front), before)) == (5, 5, 1)
    assert math.isfinite(float(m["total_loss"])) and len(front.chains) == 2

    before = _counters(front)
    state, m = step(state, _train_batches(dev, 1, 4, 576, seed=9)[0], gen)
    state, m = step(state, batches[1], gen)
    assert tuple(a - c for a, c in zip(_counters(front), before)) == (12, 6, 0)
    assert math.isfinite(float(m["total_loss"])) and len(front.chains) == 3


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-300))


@pytest.mark.parametrize("segment", [False, True])
def test_graphed_loss_terms_match_eager_terms(dev, segment):
    """The loss terms' graphs (train/graphs.py) on D-FINE-m, bs4 640^2 (with
    `segment`, the mask head and masks at 160^2): three training forwards
    under bf16 autocast with other targets each (12, 3 and 30 GTs an image,
    so a stale static input would show), and on each the loss terms through
    the graphs (the first call captures the key) and eagerly, with their
    gradients in the decoder's outputs. Each loss term within rtol 1e-5, and
    each gradient within a relative norm gap of 1e-5 (f32) or 2^-8 (bf16, one
    rounding):
    the replay runs the same kernels on the same values, but its static
    inputs are fresh allocations where the eager terms read views at an
    offset, so a reduction may vectorise and sum in another order, and the
    backward's scatter-adds sum in any order; a bf16 gradient rounds that
    difference once. The gaps of the eager terms against themselves are
    printed beside; on an H100 both read 0 at every step. Counters: 1
    capture and 1 replay on the first call, 2 replays on the next two."""
    import dataclasses
    import math

    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.models.denoising import dn_layout, draw_dn_noise
    from custom_d_fine_tpu_torch.models.dfine import build_model
    from custom_d_fine_tpu_torch.train import graphs
    from custom_d_fine_tpu_torch.train.criterion import DFINECriterion, with_mask_losses

    cfg, crit_cfg = get_model_config("m"), get_model_config("m").criterion
    if segment:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                   enable_mask_head=True))
        crit_cfg = with_mask_losses(crit_cfg)
    model = build_model(cfg, num_classes=80, seed=1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(math.sqrt(6.0))
    model = model.to(dev).to(memory_format=torch.channels_last).train()
    criterion = DFINECriterion(crit_cfg, cfg.matcher, num_classes=80)
    step_graphs = graphs.StepGraphs(criterion)
    keys = step_graphs.loss
    dec = model.decoder
    _, num_dn, _ = dn_layout(dec.num_denoising, dec.dn_max_gt, dec.num_queries)
    for i, n_gt in enumerate((12, 3, 30)):
        b = _train_batches(dev, 1, 4, 640, seed=20 + i, n_gt=n_gt)[0]
        targets = {k: b[k] for k in ("labels", "boxes", "valid")}
        x = (b["images"].float() / 255.0).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        draws = {k: v.to(dev) for k, v in
                 draw_dn_noise(torch.Generator().manual_seed(i), 4, num_dn, 80).items()}
        with torch.autocast("cuda", dtype=torch.bfloat16):
            outputs = model(x, targets=targets, dn_draws=draws, msda_value_dtype=torch.bfloat16)
        if segment:
            hm = outputs["pred_masks"].shape[-1]
            g = torch.Generator(device=dev).manual_seed(i)
            targets["masks"] = ((torch.rand(4, 100, hm, hm, device=dev, generator=g) < 0.3)
                                & targets["valid"][..., None, None]).to(torch.uint8)
        inputs = [t for t in graphs.flatten(outputs)[1] if t.requires_grad]

        def grads(losses):
            total = torch.stack(list(losses.values())).sum()
            got = torch.autograd.grad(total, inputs, allow_unused=True, retain_graph=True)
            return [None if g is None else g.detach().double().cpu() for g in got]

        before = _counters(keys)
        got, counts = step_graphs.loss_terms(model, x, outputs, targets)
        got_grads = grads(got)
        got = {k: v.detach().double().cpu() for k, v in got.items()}
        assert tuple(a - c for a, c in zip(_counters(keys), before)) == (1, int(i == 0), 0)
        assert counts == {"graph_units": 1, "eager_units": 0, "captures": int(i == 0)}
        eager = [criterion(outputs, targets) for _ in range(2)]
        want_grads = [grads(e) for e in eager]
        want = [{k: v.detach().double().cpu() for k, v in e.items()} for e in eager]
        assert list(got) == list(want[0])
        loss_gap = max(_rel_gap(got[k], want[0][k]) for k in got)
        noise = max(_rel_gap(want[1][k], want[0][k]) for k in got)
        print(f"step {i}: loss terms {loss_gap:.3e} (eager vs eager {noise:.3e})")
        for k in got:
            assert torch.allclose(got[k], want[0][k], rtol=1e-5, atol=0.0), (i, k)
        for t, a, w, w2 in zip(inputs, got_grads, want_grads[0], want_grads[1]):
            assert (a is None) == (w is None), (i, t.shape)
            if w is None:
                continue
            bound = 1e-5 if t.dtype == torch.float32 else 2.0 ** -8
            gap = _rel_gap(a, w)
            print(f"  grad {tuple(t.shape)} {t.dtype}: {gap:.3e} "
                  f"(eager vs eager {_rel_gap(w2, w):.3e})")
            assert gap <= bound, (i, tuple(t.shape), t.dtype, gap)
        del outputs, inputs, eager


# ------------------------------------------------- the matcher's packed costs

def _padded_match(sets, targets, cfg):
    """The matcher as it was before packing: every set's costs [S, B, Q, G]
    with the padded GT columns at 1e6, copied whole to the host, one scipy
    solve per set and image on the first n_b columns. -> (costs, assign)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from custom_d_fine_tpu_torch.train import matcher

    costs = []
    for o in sets:
        c = matcher.matching_cost(o["pred_logits"], o["pred_boxes"], targets["labels"],
                                  targets["boxes"], cfg)
        if o.get("pred_masks") is not None:
            c = c + matcher.mask_matching_cost(o["pred_masks"], targets["masks"], cfg)
        costs.append(c)
    valid = targets["valid"]
    costs = torch.where(valid[None, :, None, :], torch.stack(costs), 1e6).cpu().numpy()
    costs = np.nan_to_num(costs, nan=1.0)
    n_valid = valid.sum(-1).tolist()
    assign = np.full(costs.shape[:2] + costs.shape[3:], -1, np.int64)
    for s in range(costs.shape[0]):
        for b, n in enumerate(n_valid):
            if n:
                rows, cols = linear_sum_assignment(costs[s, b, :, :n])
                assign[s, b, cols] = rows
    return costs, assign


@pytest.mark.parametrize("segment", [False, True])
def test_packed_match_equals_the_padded_path(dev, monkeypatch, segment):
    """train/matcher.py:match_all_sets on D-FINE-m's shapes: 6 output sets of
    random logits and boxes (with `segment`, mask logits at 160^2 on the
    first 4), bs16, 300 queries, 100 GT slots holding 0, 1, 100 and COCO-like
    counts. Detect: the assignment bitwise the padded path's, since the
    solver sees the same values. Segment: the mask costs' GEMMs over n GT
    rows may round otherwise than over 100 (cuBLAS picks its algorithm by
    the width), so a near tie may flip: each (set, image)'s matching cost
    under the padded costs equals the padded optimum within rtol 1e-5. The
    costs and the valid mask reach the host in page-locked memory, and the
    answer is on the card."""
    import numpy as np

    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.train import matcher

    cfg = get_model_config("m").matcher
    g = torch.Generator(device=dev).manual_seed(7)
    B, Q, G, C, S, hm = 16, 300, 100, 80, 6, 160
    n_valid = torch.tensor([0, 1, 100, 7, 3, 12, 5, 1, 9, 2, 30, 4, 6, 0, 8, 11])
    valid = (torch.arange(G)[None] < n_valid[:, None]).to(dev)
    targets = {"labels": torch.randint(0, C, (B, G), device=dev, generator=g),
               "boxes": torch.cat([torch.rand(B, G, 2, device=dev, generator=g) * 0.6 + 0.2,
                                   torch.rand(B, G, 2, device=dev, generator=g) * 0.25 + 0.05],
                                  -1),
               "valid": valid}
    sets = [{"pred_logits": torch.randn(B, Q, C, device=dev, generator=g) * 2,
             "pred_boxes": torch.rand(B, Q, 4, device=dev, generator=g) * 0.5 + 0.25}
            for _ in range(S)]
    if segment:
        targets["masks"] = ((torch.rand(B, G, hm, hm, device=dev, generator=g) < 0.3)
                            & valid[..., None, None]).to(torch.uint8)
        for o in sets[:4]:
            o["pred_masks"] = torch.randn(B, Q, hm, hm, device=dev, generator=g) * 3
    pinned = []
    host = matcher._host

    def recorded(t):
        out = host(t)
        pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(matcher, "_host", recorded)
    assign, go_g, go_valid = matcher.match_all_sets(sets, targets, cfg)
    assert pinned == [True, True]
    assert all(t.device.type == "cuda" for t in (assign, go_g, go_valid))
    costs, want = _padded_match(sets, targets, cfg)
    got = assign.cpu().numpy()
    if not segment:
        np.testing.assert_array_equal(got, want)
        return
    n = n_valid.tolist()
    for s in range(S):
        for b in range(B):
            a, k = got[s, b], n[b]
            assert (a[k:] == -1).all() and len(set(a[:k].tolist())) == k and (a[:k] >= 0).all()
    total = [[[costs[s, b, x[s, b, :n[b]], np.arange(n[b])].astype(np.float64).sum()
               for b in range(B)] for s in range(S)] for x in (got, want)]
    flips = int((got != want).any(-1).sum())
    print(f"segment: {flips} of {S * B} (set, image) assignments differ from the padded path's")
    np.testing.assert_allclose(total[0], total[1], rtol=1e-5)
