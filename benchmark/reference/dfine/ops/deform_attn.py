"""Multi-scale deformable attention, plain PyTorch: the counterpart of
custom_d_fine_tpu/ops/deform_attn.py:ms_deform_attn_xla (:167-197).

`ms_deform_attn`: per-level bilinear sampling of the value maps at the
predicted locations, with the semantics of F.grid_sample(align_corners=False,
padding_mode=zeros) that the reference uses (src/d_fine/arch/utils.py:191-264),
weighted by the softmaxed attention and summed over levels and points. This
is the function the MSDA kernel (ops/msda.py) is held against.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _gather(v: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """v [B, h, HW, c], flat [B, Lq, h, P] -> [B, Lq, h, P, c]."""
    B, h, _, c = v.shape
    _, Lq, _, P = flat.shape
    idx = flat.permute(0, 2, 1, 3).reshape(B, h, Lq * P, 1).expand(-1, -1, -1, c)
    g = torch.gather(v, 2, idx)
    return g.reshape(B, h, Lq, P, c).permute(0, 2, 1, 3, 4)


def _bilinear_gather_level(value_l: torch.Tensor, loc: torch.Tensor, H: int, W: int):
    """value_l [B, H*W, h, c], loc [B, Lq, h, P, 2] (x, y) -> [B, Lq, h, P, c]."""
    x = loc[..., 0] * W - 0.5
    y = loc[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    v = value_l.transpose(1, 2)  # [B, h, HW, c]

    def corner(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return _gather(v, flat) * (w * valid.to(w.dtype))[..., None]

    return (corner(x0i, y0i, (1 - tx) * (1 - ty))
            + corner(x0i + 1, y0i, tx * (1 - ty))
            + corner(x0i, y0i + 1, (1 - tx) * ty)
            + corner(x0i + 1, y0i + 1, tx * ty))


def ms_deform_attn(
    value: torch.Tensor,                     # [B, Len_v, n_head, c], levels concatenated
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,        # [B, Lq, n_head, P_total, 2] in [0,1]
    attention_weights: torch.Tensor,         # [B, Lq, n_head, P_total] (softmaxed)
    num_points_list: Sequence[int],
) -> torch.Tensor:
    """Returns [B, Lq, n_head * c] in value's dtype."""
    B, Len_v, n_head, c = value.shape
    Lq = sampling_locations.shape[1]
    assert sum(h * w for h, w in spatial_shapes) == Len_v, (spatial_shapes, Len_v)
    out = torch.zeros((B, Lq, n_head, c), dtype=value.dtype, device=value.device)
    v_off = p_off = 0
    for (H, W), P in zip(spatial_shapes, num_points_list):
        value_l = value[:, v_off:v_off + H * W]
        loc = sampling_locations[:, :, :, p_off:p_off + P]
        w = attention_weights[:, :, :, p_off:p_off + P]
        sampled = _bilinear_gather_level(value_l, loc, H, W)
        out = out + (sampled * w[..., None]).sum(dim=3)
        v_off += H * W
        p_off += P
    return out.reshape(B, Lq, n_head * c)
