"""The one generator of inputs: it reads a traffic mix (traffic/<name>.json)
and makes its batches from --seed, on the device, in a few large calls. The
same seed gives the same inputs; every seed gives the same sizes (image
size, GT counts, box-size classes), in another order."""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F


def _images(n: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """uint8 [n, h, w, 3]: smooth random fields (1/16 resolution, bilinear
    upsampling) plus pixel noise, so that an image has structure at every
    scale and no two images are alike."""
    coarse = torch.rand((n, 3, max(h // 16, 1), max(w // 16, 1)), generator=gen,
                        device=device)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    noise = torch.rand((n, 3, h, w), generator=gen, device=device)
    img = (smooth * 200.0 + noise * 55.0).clamp_(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()


def _size_classes(mix: Dict[str, Any], n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n class ids (0 small, 1 medium, 2 large) in the mix's proportions."""
    shares = torch.tensor([mix["size_mix"][k] for k in ("small", "medium", "large")],
                          dtype=torch.float64)
    counts = torch.floor(shares / shares.sum() * n).long()
    counts[0] += n - int(counts.sum())
    return torch.repeat_interleave(torch.arange(3, device=device), counts.to(device))


def _ellipse_masks(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [n, size, size] {0,1}: for each normalised cxcywh box, the
    pixels whose centres lie in the ellipse inscribed in the box (pi/4 of
    its area). The mask head, its matching costs and its losses are dense
    over every pixel, so a mask's shape changes no op's shape or work; the
    ellipse is the simplest shape that fills part of its box. (Its share of
    the box is not taken from COCO, which the repo does not measure.)"""
    c = (torch.arange(size, device=boxes.device, dtype=torch.float32) + 0.5) / size
    cx, cy, w, h = (boxes[:, i, None, None] for i in range(4))
    u = (c[None, None, :] - cx) / (w / 2)
    v = (c[None, :, None] - cy) / (h / 2)
    return (u.square() + v.square() <= 1).to(torch.uint8)


def train_pool(mix: Dict[str, Any], seed: int, num_classes: int, device,
               mask_size: int = 0) -> List[Dict[str, torch.Tensor]]:
    """`pool` training batches of `batch` images, as the port's step takes
    them: uint8 images [B, img, img, 3], labels [B, max_gt] int64, boxes
    [B, max_gt, 4] normalised cxcywh f32, valid [B, max_gt] bool (the first
    n of a row). GT counts per image follow a geometric draw of mean
    `mean_gt` (at least 1, at most max_gt) and box sizes the COCO mix of
    small (< 32^2 px), medium and large; both multisets come from the mix's
    own `sizes_seed`, the same for every run, and --seed orders them and
    draws the images, labels, shapes and positions. Where the mix sets
    `masks` (absent: false), each batch also holds masks [B, max_gt,
    mask_size, mask_size] uint8 {0,1}: one mask per valid GT, made from
    its box (_ellipse_masks), and zeros in the padding rows. They take no
    draw, so the other tensors are those of the mix without masks."""
    B, S, G, pool = mix["batch"], mix["img"], mix["max_gt"], mix["pool"]
    n_img = pool * B
    base = torch.Generator(device=device).manual_seed(int(mix["sizes_seed"]))
    counts = torch.empty(n_img, device=device).geometric_(1.0 / mix["mean_gt"], generator=base)
    counts = counts.clamp_(1, G).long()
    n_box = int(counts.sum())
    classes = _size_classes(mix, n_box, base, device)

    gen = torch.Generator(device=device).manual_seed(int(seed))
    counts = counts[torch.randperm(n_img, generator=gen, device=device)]
    classes = classes[torch.randperm(n_box, generator=gen, device=device)]
    lo = torch.tensor([8.0, 32.0, 96.0], device=device)[classes]
    hi = torch.tensor([32.0, 96.0, 0.75 * S], device=device)[classes]
    side = lo + (hi - lo) * torch.rand(n_box, generator=gen, device=device)
    ratio = torch.exp((torch.rand(n_box, generator=gen, device=device) * 2 - 1) * math.log(2))
    bw = (side * ratio.sqrt()).clamp_(max=S)
    bh = (side / ratio.sqrt()).clamp_(max=S)
    cx = bw / 2 + (S - bw) * torch.rand(n_box, generator=gen, device=device)
    cy = bh / 2 + (S - bh) * torch.rand(n_box, generator=gen, device=device)
    flat_boxes = torch.stack([cx, cy, bw, bh], -1) / S
    flat_labels = torch.randint(0, num_classes, (n_box,), generator=gen, device=device)

    valid = torch.arange(G, device=device)[None] < counts[:, None]          # [n_img, G]
    boxes = torch.zeros((n_img, G, 4), device=device)
    boxes[..., 2:] = 0.1  # padding rows: a harmless box, never valid
    boxes[..., :2] = 0.5
    boxes[valid] = flat_boxes
    labels = torch.zeros((n_img, G), dtype=torch.long, device=device)
    labels[valid] = flat_labels
    images = _images(n_img, S, S, gen, device)
    out = [{"images": images[i * B:(i + 1) * B].contiguous(),
            "labels": labels[i * B:(i + 1) * B].contiguous(),
            "boxes": boxes[i * B:(i + 1) * B].contiguous(),
            "valid": valid[i * B:(i + 1) * B].contiguous()} for i in range(pool)]
    if mix.get("masks", False):
        if mask_size <= 0:
            raise ValueError("a mix with masks needs the model's mask_size")
        masks = torch.zeros((n_img, G, mask_size, mask_size), dtype=torch.uint8, device=device)
        masks[valid] = _ellipse_masks(flat_boxes, mask_size)
        for i, batch in enumerate(out):
            batch["masks"] = masks[i * B:(i + 1) * B].contiguous()
    return out
