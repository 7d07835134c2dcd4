"""Seeded random weights for D-FINE, made on the device in a few large draws.

The distributions follow the port's torch-parity initialisation
(reference/dfine/models/dfine.py: U(+-1/sqrt(fan_in)) for conv and linear
weights and biases, xavier for the decoder FFNs, enc_output, query_pos_head
and 1x1 input projections, xavier on the MHA in_proj; the focal prior, the
MSDA grid bias and the zeroed heads), with two changes that make every path of the forward depend on its
input, so that the check that decides `correct` can see each of them:
- every conv kernel is scaled by sqrt(6) (kaiming scale): at torch's default
  scale the features of a random D-FINE fade through ~40 convs and its
  query-selection scores tie to ~1e-6, so the top-K and the threshold would
  depend on rounding alone;
- the layers that the torch init zeroes (the box heads' last layers, the
  MSDA sampling offsets' and attention weights' projections, the gates, the
  LQE heads) are drawn like any other linear layer: zeroed, every box would
  be its anchor and every sampling point and attention weight would ignore
  the query.
All uniform leaves come from one `torch.rand` and all normal leaves from one
`torch.randn`, on a generator on the device. With the mask head on, its leaves
are drawn after those, from one more `torch.rand` and `torch.randn` on the
same generator, as the port initialises them (U(+-1/sqrt(fan_in)) for the
convs and the MLP, kaiming normal with fan_out for up_conv, GroupNorm (1, 0));
its convs keep that scale, since each feeds a GroupNorm that undoes it. So
a detect model's draws are the same with or without this rule, and a segment
model's other leaves equal the detect model's of the same seed.

Where the configuration freezes the backbone's norms (`backbone.freeze_norm`:
D-FINE-L and -X), the BatchNorms normalise with their running statistics in
training too, and those statistics have to be a pretrained front's: D-FINE-X
trains from a pretrained HGNetv2-B5 whose frozen statistics normalise its
features, while statistics of (0, 1) leave its stage outputs at a std of
~10^2-10^3 (benchmark/tests/test_bench_weights.py). So after the draws one
calibration pass (`_calibrate_frozen_norms`) sets each frozen norm's
running mean and variance to the statistics of its own input over a batch of
the generator's images (generate.py) at the traffic's image size, drawn from
a generator of their own. It draws nothing from the weights' generator, so
the draws above are the same with or without it, and a configuration without
frozen norms gets exactly what it got before.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .generate import _images
from .reference.dfine.configs import ModelConfig
from .reference.dfine.models.dfine import DFINE, _msda_offset_bias
from .reference.dfine.models.layers import BatchNorm, MultiHeadAttention, bias_init_with_prob

CONV_SCALE = math.sqrt(6.0)
CALIBRATION_IMAGES = 8  # images in the frozen norms' calibration batch
CALIBRATION_STREAM = 0x5EEDCA1B  # the calibration's generator: seed ^ this, not the draws'


def _fan_in(w: torch.Tensor) -> int:
    return w.shape[1] * int(np.prod(w.shape[2:])) if w.ndim == 4 else w.shape[1]


def _fan_out(w: torch.Tensor) -> int:
    return w.shape[0] * int(np.prod(w.shape[2:]))


def _mask_modules(model: DFINE) -> List[nn.Module]:
    dec = model.decoder
    if not dec.enable_mask_head:
        return []
    return list(dec.mask_decoder.modules()) + list(dec.mask_head.modules())


def _mask_plan(model: DFINE) -> Tuple[List[Tuple[torch.Tensor, float]],
                                      List[Tuple[torch.Tensor, float]]]:
    """The mask head's (uniform leaves, normal leaves), as the port's
    apply_torch_default_init draws them (published dfine_decoder.py:351 for
    up_conv)."""
    uniform, normal = [], []
    up_conv = model.decoder.mask_decoder.up_conv
    for m in _mask_modules(model):
        if m is up_conv:
            normal.append((m.weight, math.sqrt(2.0 / _fan_out(m.weight))))
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            uniform.append((m.weight, 1.0 / math.sqrt(_fan_in(m.weight))))
            if m.bias is not None:
                uniform.append((m.bias, 1.0 / math.sqrt(_fan_in(m.weight))))
    return uniform, normal


def _draw_plan(model: DFINE) -> Tuple[List[Tuple[torch.Tensor, float]],
                                      List[Tuple[torch.Tensor, float]]]:
    """(uniform leaves with their bound, normal leaves with their std), the
    mask head's left out."""
    dec = model.decoder
    skip = {id(m) for m in _mask_modules(model)}
    xavier = set()
    for layer in dec.decoder.layers:
        xavier |= {id(layer.linear1), id(layer.linear2)}
    xavier |= {id(dec.enc_output.proj), id(dec.query_pos_head.layers[0]),
               id(dec.query_pos_head.layers[1])}
    for proj in list(model.encoder.input_proj) + list(dec.input_proj):
        if isinstance(proj, nn.Sequential) and proj.conv.kernel_size == (1, 1):
            xavier.add(id(proj.conv))
    uniform, normal = [], []
    for m in model.modules():
        if id(m) in skip:
            continue
        if isinstance(m, MultiHeadAttention):
            uniform.append((m.in_proj_weight, math.sqrt(6.0 / (4.0 * m.embed_dim))))
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            scale = CONV_SCALE if isinstance(m, nn.Conv2d) else 1.0
            if id(m) in xavier:
                b = math.sqrt(6.0 / (_fan_in(m.weight) + _fan_out(m.weight)))
            else:
                b = 1.0 / math.sqrt(_fan_in(m.weight))
            uniform.append((m.weight, scale * b))
            if m.bias is not None:
                uniform.append((m.bias, 1.0 / math.sqrt(_fan_in(m.weight))))
    if hasattr(dec, "denoising_class_embed"):
        normal.append((dec.denoising_class_embed.weight, 1.0))
    return uniform, normal


def _fill(leaves: List[Tuple[torch.Tensor, float]], flat: torch.Tensor) -> None:
    sizes = [t.numel() for t, _ in leaves]
    scale = torch.repeat_interleave(
        torch.tensor([s for _, s in leaves], device=flat.device, dtype=flat.dtype),
        torch.tensor(sizes, device=flat.device))
    parts = (flat * scale).split(sizes)
    torch._foreach_copy_([t for t, _ in leaves], [p.view_as(t) for p, (t, _) in
                                                  zip(parts, leaves)])


def calibration_images(seed: int, img: int, device) -> torch.Tensor:
    """The frozen norms' calibration batch for `seed`: CALIBRATION_IMAGES of
    the generator's images at img x img, as the step feeds them (NCHW f32
    in [0, 1])."""
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ CALIBRATION_STREAM)
    images = _images(CALIBRATION_IMAGES, img, img, gen, device)
    return (images.float() / 255.0).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def _calibrate_frozen_norms(model: DFINE, seed: int, img: int, device) -> None:
    """Set each frozen BatchNorm's running statistics to the batch statistics
    of its own input over the calibration batch, in one train-mode pass of the
    backbone with the `frozen` flags off and momentum 1 (so the running mean
    is the batch mean, and the running variance the biased batch variance by
    the rule of the reference's BatchNorm); each norm normalises the batch as
    it will with the statistics it keeps, so every later norm sees the input
    that it will see. The flags, momenta and batch counts come back after it.
    The convolutions run in f32 without TF32, as the reference does."""
    from .runners.common import strict_fp32  # which imports this module

    norms = [m for m in model.backbone.modules() if isinstance(m, BatchNorm) and m.frozen]
    saved = [(m.momentum, m.num_batches_tracked.clone()) for m in norms]
    try:
        for m in norms:
            m.frozen, m.momentum = False, 1.0
        with strict_fp32():
            model.backbone.train()(calibration_images(seed, img, device))
    finally:
        for m, (momentum, count) in zip(norms, saved):
            m.frozen, m.momentum = True, momentum
            m.num_batches_tracked.copy_(count)


@torch.no_grad()
def make_weights(cfg: ModelConfig, num_classes: int, seed: int, device: torch.device,
                 img: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model's state_dict (f32, on `device`) for `seed`: the same seed
    gives the same tensors on the same device type. `img`, the traffic's
    image side, is needed where the backbone's norms are frozen: their
    statistics are calibrated at that size."""
    with torch.device(device):
        model = DFINE(cfg, num_classes=num_classes)  # constants from the modules' own init
    gen = torch.Generator(device=device).manual_seed(int(seed))
    plans = [_draw_plan(model)] + ([_mask_plan(model)] if cfg.decoder.enable_mask_head else [])
    for uniform, normal in plans:
        n_u = sum(t.numel() for t, _ in uniform)
        n_n = sum(t.numel() for t, _ in normal)
        _fill(uniform, torch.rand(n_u, generator=gen, device=device).mul_(2.0).sub_(1.0))
        _fill(normal, torch.randn(n_n, generator=gen, device=device))
    for m in model.modules():  # torch MHA zeroes both projection biases
        if isinstance(m, MultiHeadAttention):
            m.in_proj_bias.zero_()
            m.out_proj.bias.zero_()
    dec = model.decoder
    cls_bias = bias_init_with_prob(0.01)  # the focal prior
    dec.enc_score_head.bias.fill_(cls_bias)
    for head in dec.dec_score_head:
        head.bias.fill_(cls_bias)
    d = cfg.decoder
    grid = torch.from_numpy(_msda_offset_bias(d.nhead, d.num_points)).to(device)
    for layer in dec.decoder.layers:  # the sampling grid around each reference point
        layer.cross_attn.sampling_offsets.bias.copy_(grid)
    if hasattr(dec, "denoising_class_embed"):
        dec.denoising_class_embed.weight[-1].zero_()
    if cfg.backbone.freeze_norm:
        if img is None:
            raise ValueError("frozen backbone norms are calibrated at the traffic's image "
                             "size: pass img")
        _calibrate_frozen_norms(model, seed, img, device)
    return {k: v.detach() for k, v in model.state_dict().items()}
