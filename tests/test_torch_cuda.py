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


def test_profiling_helpers_read_the_card(dev):
    """utils/profiling.py on a matmul: the profiler's device events, the
    trace summary, StepTimer and the memory statistics."""
    from custom_d_fine_tpu_torch.utils import profiling

    a = torch.randn(512, 512, device=dev)
    spans = profiling.device_spans(lambda: a @ a, 3)
    assert len(spans) >= 3 and all(d > 0 for _, _, d in spans)
    assert 0 < profiling.busy_ms(spans) <= sum(d for _, _, d in spans) / 1e6
    out, top = profiling.trace(lambda x: x @ x, a, n=2)
    assert out.shape == (512, 512) and top and top[0][1] > 0
    ev = profiling.events_by_name(lambda: a @ a, n=2)
    assert ev and ev[0]["calls"] >= 1
    assert profiling.StepTimer(lambda: a @ a).measure(n=5, warmup=1) > 0
    mem = profiling.device_memory_stats()
    assert len(mem) == torch.cuda.device_count() and mem[0]["bytes_in_use_mb"] > 0
