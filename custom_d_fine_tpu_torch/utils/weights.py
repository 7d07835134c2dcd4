"""Carry the JAX package's weights into the port: flax {params, batch_stats}
(nested dicts of numpy arrays) -> the port's state_dict.

This is the inverse of custom_d_fine_tpu/utils/torch_convert.py:
convert_torch_state (:92-208) and its name map _to_flax_path (:34-83). The
port's modules carry the original torch repo's state_dict names, so:
  - flax module names map back to torch names (stages_0 -> stages.0,
    agg_squeeze -> aggregation.0, cv2_csp -> cv2.0, decoder_layers_0 ->
    decoder.layers.0, ...);
  - conv kernels go HWIO -> OIHW, Dense kernels [in,out] -> Linear [out,in];
  - q_proj/k_proj/v_proj pack into the MHA in_proj_weight/in_proj_bias;
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
    (+ num_batches_tracked = 0); the BN module is `bn` inside the backbone's
    ConvBNAct and `norm` elsewhere, as in the original repo;
  - LayerNorm and GroupNorm scale -> weight; the MaskDecoder's lateral_i
    and gn_i -> lateral.i and bn.i; a deploy VGGBlock's `fused` conv -> `conv`.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_SEGMENTS = [
    (r"stages_(\d+)", r"stages.\1"),
    (r"blocks_(\d+)", r"blocks.\1"),
    (r"layers_(\d+)", r"layers.\1"),
    (r"agg_squeeze", "aggregation.0"),
    (r"agg_excite", "aggregation.1"),
    (r"input_proj_(\d+)_(conv|norm)", r"input_proj.\1.\2"),
    (r"encoder_(\d+)_layers_(\d+)", r"encoder.\1.layers.\2"),
    (r"(lateral_convs|fpn_blocks|pan_blocks|bottlenecks|dec_score_head|dec_bbox_head)_(\d+)",
     r"\1.\2"),
    (r"downsample_convs_(\d+)", r"downsample_convs.\1.0"),
    (r"(cv2|cv3)_csp", r"\1.0"),
    (r"(cv2|cv3)_conv", r"\1.1"),
    (r"decoder_layers_(\d+)", r"decoder.layers.\1"),
    (r"lqe_layers_(\d+)", r"decoder.lqe_layers.\1"),
    (r"enc_output_(proj|norm)", r"enc_output.\1"),
    (r"lateral_(\d+)", r"lateral.\1"),  # MaskDecoder
    (r"gn_(\d+)", r"bn.\1"),
    (r"fused", "conv"),
]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _module_name(path: Tuple[str, ...]) -> str:
    """Flax module path (no leaf) -> torch module name."""
    segs = []
    for seg in path:
        for pat, rep in _SEGMENTS:
            if re.fullmatch(pat, seg):
                seg = re.sub(pat, rep, seg)
                break
        segs.append(seg)
    return ".".join(segs)


def flax_to_torch(params: Mapping, batch_stats: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax {params, batch_stats} of the JAX package's model -> the port's
    state_dict (f32 tensors on the CPU).

    `prefix` is the flax path ("a/b/c") at which `params` sits inside a whole
    DFINE tree when a subtree is converted; the returned names are relative
    to it. It only decides whether the backbone's BN naming applies.
    """
    root = tuple(p for p in prefix.split("/") if p)
    flat_p = {root + k: v for k, v in _flatten(params).items()}
    flat_s = {root + k: v for k, v in _flatten(batch_stats).items()}
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}

    for path, val in flat_p.items():
        *mod, leaf = path
        if len(mod) >= 2 and mod[-2] == "self_attn" and mod[-1] in ("q_proj", "k_proj", "v_proj"):
            name = _module_name(tuple(mod[:-1]))
            qkv.setdefault((name, leaf), {})[mod[-1]] = val
            continue
        if mod and mod[-1] == "bn":  # BatchNorm: <x>/norm/bn or input_proj_i_norm/bn
            name = _bn_name(tuple(mod[:-1]))
            sd[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = val
            continue
        name = _module_name(tuple(mod))
        if leaf == "kernel":
            sd[f"{name}.weight"] = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
        elif leaf == "embedding":
            sd[f"{name}.weight"] = val
        elif leaf == "scale" and mod[-1] != "lab":  # LayerNorm, GroupNorm
            sd[f"{name}.weight"] = val
        else:  # biases, LAB scale/bias
            sd[f"{name}.{leaf}"] = val

    for (name, leaf), parts in qkv.items():
        mats = [parts[k] for k in ("q_proj", "k_proj", "v_proj")]
        if leaf == "kernel":
            sd[f"{name}.in_proj_weight"] = np.concatenate([m.T for m in mats], axis=0)
        else:
            sd[f"{name}.in_proj_bias"] = np.concatenate(mats, axis=0)

    for path, val in flat_s.items():
        *mod, leaf = path
        name = _bn_name(tuple(mod[:-1]))
        sd[f"{name}.{'running_mean' if leaf == 'mean' else 'running_var'}"] = val
        sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)

    cut = len(_module_name(root)) + 1 if root else 0
    return {k[cut:]: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype == np.int64 else v.astype(np.float32))) for k, v in sd.items()}


def _bn_name(mod: Tuple[str, ...]) -> str:
    """Flax path of the module that holds `bn` -> torch BatchNorm name."""
    name = _module_name(mod)
    if mod and mod[0] == "backbone" and mod[-1] == "norm":
        name = name[: -len("norm")] + "bn"
    return name


def flax_train_state_to_torch(params: Mapping, batch_stats: Mapping, ema: Mapping = None
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The JAX package's TrainState (params, batch_stats and its ema tree
    {"params", "batch_stats"}) -> (state_dict, ema state_dict) of the port,
    both through flax_to_torch. The optimizer state is not carried: AdamW
    starts at zero on both sides. ema None gives None."""
    sd = flax_to_torch(params, batch_stats)
    return sd, (None if ema is None else flax_to_torch(ema["params"], ema["batch_stats"]))
