"""The yardstick's arithmetic: the H100's published peaks, roofline bounds,
and the work that the port's kernels must do on given inputs. Copied from
the port's `chip_smoke.py` (`bound`, `msda_rows`, `msda_work`,
`msda_bwd_work`), with the level layout taken from the op's own arguments.
A bound counts the work the inputs need, whatever kernel computes it: each
touched value row once, loc, attn and out once."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s; f32 outside the tensor
# cores; TF32, bf16 on the tensor cores. All at the 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12


def bound_s(bytes_: float, flops: float, peak_ops: float) -> float:
    """The least seconds a call can take: bytes at HBM bandwidth or
    operations at `peak_ops`, whichever is longer."""
    return max(bytes_ / PEAK_BYTES, flops / peak_ops)


def msda_rows(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor, num_points: Sequence[int]) -> Tuple[int, int]:
    """(value rows that valid bilinear corners touch, each counted once;
    the number of valid corners) on these inputs."""
    B, Lv, h, c = value.shape
    keys, n_valid, p_off, start = [], 0, 0, 0
    bidx = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    hidx = torch.arange(h, device=loc.device).view(1, 1, h, 1)
    for (H, W), P in zip(spatial_shapes, num_points):
        lp = loc[:, :, :, p_off:p_off + P].float()
        x0 = torch.floor(lp[..., 0] * W - 0.5).long()
        y0 = torch.floor(lp[..., 1] * H - 0.5).long()
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            rows = ((bidx * Lv + start + yi * W + xi) * h + hidx).expand_as(valid)
            keys.append(rows[valid])
            n_valid += int(valid.sum())
        p_off += P
        start += H * W
    return int(torch.unique(torch.cat(keys)).numel()), n_valid


def msda_work(value: torch.Tensor, spatial_shapes, loc: torch.Tensor, attn: torch.Tensor,
              num_points) -> Tuple[int, float]:
    """(bytes, flops) the MSDA forward needs: touched value rows read once,
    loc and attn read once, the f32 output written once; per valid corner and
    channel a multiply-add, per point and channel the attention weighting."""
    B, Lv, h, c = value.shape
    n_rows, n_valid = msda_rows(value, spatial_shapes, loc, num_points)
    bytes_ = (n_rows * c * value.element_size() + loc.numel() * 4 + attn.numel() * 4
              + B * loc.shape[1] * h * c * 4)
    return bytes_, float(c * (2 * n_valid + 2 * attn.numel()))


def msda_bwd_work(value: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                  attn: torch.Tensor, num_points) -> Tuple[int, float]:
    """(bytes, flops) the MSDA backward needs: the touched value rows, loc,
    attn and grad_out read once; dvalue (value's dtype, every position), dloc
    and dattn written once. Per valid corner and channel: the dvalue term
    (2 flops), three <g, .> sums (2 each) and the corner weights (~4)."""
    B, Lv, h, c = value.shape
    n_rows, n_valid = msda_rows(value, spatial_shapes, loc, num_points)
    Lq = loc.shape[1]
    bytes_ = (n_rows * c * value.element_size() + 2 * (loc.numel() * 4 + attn.numel() * 4)
              + B * Lq * h * c * 4 + value.numel() * value.element_size())
    return bytes_, float(12 * c * n_valid)
