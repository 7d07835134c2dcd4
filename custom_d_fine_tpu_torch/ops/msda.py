"""MSDA kernel wrappers (csrc/msda.cu forward, csrc/msda_bwd.cu backward),
their plain PyTorch versions, and the autograd Function that joins them.

The forward replaces the TPU kernels
custom_d_fine_tpu/ops/pallas/msda_sep.py:_sep_kernel, ops/pallas/msda.py:_level_kernel
and, in function, msda_sep.py:_sep_kernel_psum: one gather kernel over all
levels, levels x points summed in f32 registers. Bound on the H100: bytes
(D-FINE-m 640^2: ~2.7 MB at bs1, 0.8 us; ~58.8 MB for the bf16 training
step's bs16 x 500 queries, 17.5 us). The first design (one warp per
(b, q, head), one lane per channel, every lane loading the same loc and attn
and then its own narrow corner loads, point after point) took 0.117 ms at the
training shapes: two dependent memory round trips per point. The current
design prepares each point once (one lane per point: coalesced loc and attn,
corners, weights), hands it to a slot of lanes by shuffles, loads 16 bytes
of channels per lane with every corner of an item's points in flight at
once, packs two items per warp where that leaves no slot idle, and sums the
slots by halving exchanges into one coalesced row store. c not a multiple of
the 16-byte width, or an unaligned pointer, takes the same kernel with one
channel per lane. On one H100 (700 W) it takes ~0.045 ms at the training
shapes (first design 0.116) and ~0.0035 ms at bs1 (0.0078): a warp's two
dependent round trips (loc, then its corner rows) set the time. Dropped
after measuring (source note in csrc/msda.cu): all rounds in flight at once,
warps that loop over groups with the next loc prefetched, and staging the
small levels in shared memory per (b, head).

The backward replaces ops/pallas/msda_sep.py:_sep_bwd_kernel (levels of
>= 1024 positions) and ops/pallas/msda.py:_level_bwd_kernel (small levels).
Bound on the H100: bytes (a bs16 training call must move ~137 MB, most of
it the bf16 dvalue written once and the value rows read once). Two kernels
of csrc/msda_bwd.cu, counted as one launch: dloc and dattn from per-corner
<g, v> sums, one warp per (b, q, head) with 16-byte channel loads; dvalue
gathered per CTA into an f32 slab in shared memory (a rectangle of one
(b, head, level) map) and stored once in value's dtype, so the call needs
no f32 buffer, no zero-fill, no cast and no global atomic.

`msda_fwd` and `msda_bwd` take the plain version only for tensors on the
CPU. For a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .deform_attn import _gather, ms_deform_attn


def level_start_index(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return tuple(starts)


def msda_fwd_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   level_start: Sequence[int], loc: torch.Tensor, attn: torch.Tensor,
                   num_points_list: Sequence[int]) -> torch.Tensor:
    """value f32 or bf16 [B, Len_v, h, c]; loc f32 [B, Lq, h, P, 2] (x, y);
    attn f32 [B, Lq, h, P] -> f32 [B, Lq, h*c]. bf16 values are widened to
    f32 first, as the kernel does on load."""
    _check_levels(spatial_shapes, level_start, num_points_list)
    return ms_deform_attn(value.float(), spatial_shapes, loc.float(), attn.float(),
                          num_points_list)


def _check_levels(spatial_shapes, level_start, num_points_list) -> None:
    if len(num_points_list) != len(spatial_shapes):
        raise ValueError("msda_fwd: spatial_shapes and num_points_list differ in length")
    if tuple(int(s) for s in level_start) != level_start_index(spatial_shapes):
        raise ValueError(f"msda_fwd: level_start {tuple(level_start)} does not match "
                         f"spatial_shapes {list(spatial_shapes)}")


def _check(t: torch.Tensor, name: str, dtypes, shape, fn: str = "msda_fwd") -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{fn}: {name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _level_args(spatial_shapes, level_start, num_points_list, value, fn):
    """Normalised level lists and the kernel's (H, W, start, P) table."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    level_start = [int(s) for s in level_start]
    num_points_list = [int(p) for p in num_points_list]
    _check_levels(spatial_shapes, level_start, num_points_list)
    if sum(h * w for h, w in spatial_shapes) != value.shape[1]:
        raise ValueError(f"{fn}: spatial_shapes {spatial_shapes} do not cover "
                         f"Len_v={value.shape[1]}")
    info = [v for (h, w), s, p in zip(spatial_shapes, level_start, num_points_list)
            for v in (h, w, s, p)]
    return sum(num_points_list), (ctypes.c_int * len(info))(*info), len(spatial_shapes)


def msda_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             level_start: Sequence[int], loc: torch.Tensor, attn: torch.Tensor,
             num_points_list: Sequence[int]) -> torch.Tensor:
    """Same signature and result as msda_fwd_plain; launches csrc/msda.cu for
    CUDA tensors and counts the launch in `msda_fwd.launches`."""
    if value.device.type == "cpu":
        return msda_fwd_plain(value, spatial_shapes, level_start, loc, attn, num_points_list)
    from ._ext import load

    B, Lv, nh, c = value.shape
    Lq = loc.shape[1]
    P, info, n_levels = _level_args(spatial_shapes, level_start, num_points_list, value,
                                    "msda_fwd")
    _check(value, "value", (torch.float32, torch.bfloat16), (B, Lv, nh, c))
    _check(loc, "loc", (torch.float32,), (B, Lq, nh, P, 2))
    _check(attn, "attn", (torch.float32,), (B, Lq, nh, P))
    if not (value.device == loc.device == attn.device):
        raise ValueError("msda_fwd: value, loc and attn lie on different devices")
    out = torch.empty((B, Lq, nh * c), dtype=torch.float32, device=value.device)
    lib = load("msda")
    fn = lib.msda_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), int(value.dtype == torch.bfloat16), loc.data_ptr(),
                 attn.data_ptr(), out.data_ptr(), B, Lv, nh, c, Lq, n_levels, info, stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd: kernel launch failed with CUDA error {err}")
    msda_fwd.launches += 1
    return out


msda_fwd.launches = 0


def msda_bwd_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   level_start: Sequence[int], loc: torch.Tensor, attn: torch.Tensor,
                   grad_out: torch.Tensor, num_points_list: Sequence[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of msda_fwd_plain, written out: value f32 or bf16
    [B, Len_v, h, c], loc f32 [B, Lq, h, P, 2], attn f32 [B, Lq, h, P],
    grad_out f32 [B, Lq, h*c] -> (dvalue in value's dtype, dloc f32,
    dattn f32). Per level and corner: dvalue += attn * w * g (scatter-add),
    dattn += w * <g, v>, d(tx, ty) += dw/d(tx, ty) * <g, v>; corners outside
    the map contribute nothing. Sums in f32, as the kernel."""
    _check_levels(spatial_shapes, level_start, num_points_list)
    B, Lv, nh, c = value.shape
    Lq = loc.shape[1]
    v_all = value.float().transpose(1, 2)                       # [B, h, Lv, c]
    g = grad_out.float().reshape(B, Lq, nh, 1, c)
    dv = torch.zeros((B, nh, Lv, c), dtype=torch.float32, device=value.device)
    dlocs, dattns = [], []
    p_off = 0
    for (H, W), s, P in zip(spatial_shapes, level_start, num_points_list):
        lp = loc[:, :, :, p_off:p_off + P].float()
        a = attn[:, :, :, p_off:p_off + P].float()
        x = lp[..., 0] * W - 0.5
        y = lp[..., 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        v = v_all[:, :, s:s + H * W]
        da = torch.zeros_like(a)
        dtx = torch.zeros_like(a)
        dty = torch.zeros_like(a)
        #        dx dy  w                    dw/dtx     dw/dty
        for dx, dy, w, wx, wy in ((0, 0, (1 - tx) * (1 - ty), -(1 - ty), -(1 - tx)),
                                  (1, 0, tx * (1 - ty), 1 - ty, -tx),
                                  (0, 1, (1 - tx) * ty, -ty, 1 - tx),
                                  (1, 1, tx * ty, ty, tx)):
            xi, yi = x0i + dx, y0i + dy
            valid = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).float()
            flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)  # [B, Lq, h, P]
            d = (_gather(v, flat) * g).sum(-1) * valid          # <g, v_corner>
            da += w * d
            dtx += wx * d
            dty += wy * d
            contrib = (a * w * valid)[..., None] * g            # [B, Lq, h, P, c]
            idx = (flat.permute(0, 2, 1, 3).reshape(B, nh, Lq * P, 1)
                   .expand(-1, -1, -1, c))
            dv[:, :, s:s + H * W].scatter_add_(
                2, idx, contrib.permute(0, 2, 1, 3, 4).reshape(B, nh, Lq * P, c))
        dattns.append(da)
        dlocs.append(torch.stack([a * dtx * W, a * dty * H], dim=-1))
        p_off += P
    return (dv.transpose(1, 2).to(value.dtype).contiguous(), torch.cat(dlocs, dim=3),
            torch.cat(dattns, dim=3))


def msda_bwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             level_start: Sequence[int], loc: torch.Tensor, attn: torch.Tensor,
             grad_out: torch.Tensor, num_points_list: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same signature and result as msda_bwd_plain; launches csrc/msda_bwd.cu
    for CUDA tensors and counts the launch in `msda_bwd.launches`. The kernel
    writes every element of dvalue, in value's dtype, into memory from
    torch.empty; it sums with shared-memory f32 atomics, so dvalue's last
    bits vary from run to run."""
    if value.device.type == "cpu":
        return msda_bwd_plain(value, spatial_shapes, level_start, loc, attn, grad_out,
                              num_points_list)
    from ._ext import load

    B, Lv, nh, c = value.shape
    Lq = loc.shape[1]
    P, info, n_levels = _level_args(spatial_shapes, level_start, num_points_list, value,
                                    "msda_bwd")
    _check(value, "value", (torch.float32, torch.bfloat16), (B, Lv, nh, c), "msda_bwd")
    _check(loc, "loc", (torch.float32,), (B, Lq, nh, P, 2), "msda_bwd")
    _check(attn, "attn", (torch.float32,), (B, Lq, nh, P), "msda_bwd")
    _check(grad_out, "grad_out", (torch.float32,), (B, Lq, nh * c), "msda_bwd")
    if not (value.device == loc.device == attn.device == grad_out.device):
        raise ValueError("msda_bwd: value, loc, attn and grad_out lie on different devices")
    dvalue = torch.empty((B, Lv, nh, c), dtype=value.dtype, device=value.device)
    dloc = torch.empty((B, Lq, nh, P, 2), dtype=torch.float32, device=value.device)
    dattn = torch.empty((B, Lq, nh, P), dtype=torch.float32, device=value.device)
    fn = load("msda_bwd").msda_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), int(value.dtype == torch.bfloat16), loc.data_ptr(),
                 attn.data_ptr(), grad_out.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                 dattn.data_ptr(), B, Lv, nh, c, Lq, n_levels, info, stream)
    if err != 0:
        raise RuntimeError(f"msda_bwd: kernel launch failed with CUDA error {err}")
    msda_bwd.launches += 1
    return dvalue, dloc, dattn


msda_bwd.launches = 0


class MSDAFunction(torch.autograd.Function):
    """out = msda_fwd(value, loc, attn); its backward is msda_bwd. Takes value
    f32 or bf16 and loc/attn f32, contiguous (see `msda`, which casts)."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes, level_start, num_points_list):
        ctx.levels = (spatial_shapes, level_start, num_points_list)
        ctx.save_for_backward(value, loc, attn)
        return msda_fwd(value, spatial_shapes, level_start, loc, attn, num_points_list)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        spatial_shapes, level_start, num_points_list = ctx.levels
        dvalue, dloc, dattn = msda_bwd(value, spatial_shapes, level_start, loc, attn,
                                       grad_out.float().contiguous(), num_points_list)
        return dvalue, dloc, dattn, None, None, None


def msda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
         attn: torch.Tensor, num_points_list: Sequence[int]) -> torch.Tensor:
    """Differentiable MSDA: value [B, Len_v, h, c] (f32, or bf16 as the value
    map of the bf16 paths), loc [B, Lq, h, P, 2], attn [B, Lq, h, P] of any
    float dtype -> f32 [B, Lq, h*c]. loc and attn are cast to f32 here, so
    each gradient comes back in its input's dtype."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.dtype not in (torch.float32, torch.bfloat16):
        value = value.float()
    return MSDAFunction.apply(value.contiguous(), loc.float().contiguous(),
                              attn.float().contiguous(), spatial_shapes,
                              level_start_index(spatial_shapes), tuple(num_points_list))
