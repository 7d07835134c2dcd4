"""Loading torch checkpoints of the original repo into the port.

The port's copies of unwrap_torch_checkpoint, remap_obj365_head,
load_torch_checkpoint_file and load_hgnetv2_pretrained
(custom_d_fine_tpu/utils/torch_convert.py:210-311; reference
src/d_fine/utils.py:8-181 and arch/hgnetv2.py:490-545). The port's modules
carry the original repo's state_dict names, so a checkpoint loads without a
name map: `load_matched` takes every key whose name and shape match (the
reference's matched_state) and reports the rest.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .logging import logger

# Objects365 ids matching COCO classes in order (reference utils.py:8-98)
OBJ365_IDS = [
    0, 46, 5, 58, 114, 55, 116, 65, 21, 40, 176, 127, 249, 24, 56, 139, 92,
    78, 99, 96, 144, 295, 178, 180, 38, 39, 13, 43, 120, 219, 148, 173, 165,
    154, 137, 113, 145, 146, 204, 8, 35, 10, 88, 84, 93, 26, 112, 82, 265,
    104, 141, 152, 234, 143, 150, 97, 2, 50, 25, 75, 98, 153, 37, 73, 115,
    132, 106, 61, 163, 134, 277, 81, 133, 18, 94, 30, 169, 70, 328, 226,
]

# where the reference downloads the ImageNet stage-1 HGNetv2 weights from
HGNETV2_URL = ("https://github.com/Peterande/storage/releases/download/dfinev1.0/"
               "PPHGNetV2_{arch}_stage1.pth")


def unwrap_torch_checkpoint(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """Prefer EMA weights, then the raw model (reference utils.py:156-170)."""
    if "ema" in ckpt and isinstance(ckpt["ema"], dict) and "module" in ckpt["ema"]:
        return dict(ckpt["ema"]["module"])
    if "model" in ckpt:
        return dict(ckpt["model"])
    return dict(ckpt)


def remap_obj365_head(state: Mapping[str, Any], num_classes: int) -> Dict[str, Any]:
    """Map Objects365-pretrained classification rows onto COCO-sized heads
    (reference utils.py:92-137): score-head weights and biases with 366/365
    rows take, for COCO class c, pretrain row OBJ365_IDS[c] + 1 (the +1 skips
    the checkpoint's leading non-class row). A size-mismatched
    `denoising_class_embed` is dropped, so the target keeps its own init.
    Takes numpy arrays or tensors."""
    out = dict(state)
    for k, v in state.items():
        if v.ndim == 0:
            continue
        if "denoising_class_embed" in k:
            if v.shape[0] != num_classes + 1:  # embedding rows = nc + pad row
                del out[k]
        elif re.search(r"score_head", k) and v.shape[0] in (365, 366):
            out[k] = v[np.asarray(OBJ365_IDS[:num_classes]) + 1]
    return out


def load_torch_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file's state_dict (EMA weights first), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {k: (v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
            for k, v in unwrap_torch_checkpoint(ckpt).items()}


def load_matched(model: nn.Module, state: Mapping[str, torch.Tensor]
                 ) -> Dict[str, list]:
    """Copy every entry of `state` whose name and shape match the model's
    (reference matched_state, d_fine/utils.py:140-154). Returns the report
    {"missed": model keys not in state, "unmatched": state keys not in the
    model, "shape_mismatch": keys whose shapes differ}."""
    own = model.state_dict()
    report = {"missed": [k for k in own if k not in state],
              "unmatched": [k for k in state if k not in own], "shape_mismatch": []}
    load = {}
    for k, v in state.items():
        if k not in own:
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(own[k].shape):
            report["shape_mismatch"].append(k)
        else:
            load[k] = v
    model.load_state_dict(load, strict=False)
    return report


def load_hgnetv2_pretrained(model: nn.Module, arch: str,
                            local_model_dir: str = "weight/hgnetv2/") -> Dict[str, list]:
    """ImageNet stage-1 HGNetv2 weights into `model.backbone`, from the local
    file <local_model_dir>/PPHGNetV2_<arch>_stage1.pth (reference
    hgnetv2.py:490-545). Nothing is downloaded: if the file is missing this
    warns, keeps the random init and returns {"error": ...}. Otherwise the
    report of load_matched on the backbone's keys."""
    path = Path(local_model_dir) / f"PPHGNetV2_{arch}_stage1.pth"
    if not path.exists():
        logger.warning(f"pretrained HGNetv2 {arch} not found at {path}; keeping the random "
                       f"init (the reference downloads it from "
                       f"{HGNETV2_URL.format(arch=arch)})")
        return {"error": f"{path} not found"}
    return load_matched(model.backbone, load_torch_checkpoint_file(str(path)))
