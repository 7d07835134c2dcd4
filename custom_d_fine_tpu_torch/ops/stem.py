"""HGNetv2 stem kernel wrappers (csrc/stem.cu exact, csrc/stem_tc.cu fast)
and their plain PyTorch version.

Replaces the TPU kernel custom_d_fine_tpu/ops/pallas/stem.py:_stem_kernel:
the whole eval-mode StemBlock (stem1 3x3/s2 -> pad -> {stem2a -> pad ->
stem2b | maxpool 2x2/s1} -> concat -> stem3 3x3/s2 -> stem4 1x1, each with
folded BN, ReLU and LAB) from raw uint8 pixels to the stride-4 map, in the
TPU kernel's two precision modes (`fused_stem(..., fast=...)`):

- exact (`fast=False`): f32 throughout. csrc/stem.cu runs it on CUDA cores;
  ~1.17 GFLOP per 640^2 image bounds it by f32 operations (~17 us at
  67 TFLOP/s).
- fast (`fast=True`, what serving runs on the card, as the JAX package's
  serving runs `fused_stem(fast=True)` on the TPU): each conv's two operands,
  the activation and the folded weight (w1 with its 1/255), rounded to bf16;
  products summed in f32; bias, ReLU, LAB and the maxpool in f32; output
  f32. On bf16 tensor cores the same work takes ~1.2 us, so bytes (~4.5 MB,
  ~1.3 us) bound it. csrc/stem_tc.cu keeps the exact kernel's fused,
  halo'd one-CTA-per-tile structure, with every conv an implicit GEMM on
  `mma.sync` and the intermediates in shared memory as bf16.

The TPU kernel's fast mode also rounds stem3's per-dx partial sums to bf16
before its one-hot compaction (pallas/stem.py `compact`): an artefact of its
lane layout, not part of the function, and not copied here.

`stem_fwd` calls the custom op `dfine_port::stem_fwd`, whose CPU
implementation is the plain version and whose CUDA implementation launches
the kernel of the mode asked for or raises. The op has a fake (shape-only)
implementation, so the serving graph exports with torch.export and the
artifact keeps the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models.layers import BN_EPS

STEM_CONVS = ("stem1", "stem2a", "stem2b", "stem3", "stem4")
WEIGHT_KEYS = ("w1", "b1", "w2a", "b2a", "w2b", "b2b", "w3", "b3", "w4", "b4", "lab")
BIAS_KEYS = ("b1", "b2a", "b2b", "b3", "b4", "lab")


def _fragments(wt: torch.Tensor) -> torch.Tensor:
    """[N, K] f32 (N % 8 == 0) -> bf16 in the B-operand order of
    mma.m16n8k16: K padded to 16 with zeros; for each 8-column tile j and
    16-deep step s, lane g*4+t holds (k = 2t, 2t+1, 2t+8, 2t+9; n = 8j+g)."""
    N, K = wt.shape
    wt = F.pad(wt, (0, -K % 16))
    f = wt.reshape(N // 8, 8, -1, 2, 4, 2).permute(0, 2, 1, 4, 3, 5)
    return f.reshape(-1).to(torch.bfloat16)


def pack_fast_weights(fw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The fast kernel's weights: the five convs as [Cout, taps x Cin] in
    fragment order, one bf16 buffer (csrc/stem_tc.cu reads it in this
    order). stem2a's Cout and stem2b's Cin (M2) are padded to a multiple of
    8 with zeros; stem1's K (27) and stem4's (M) to a multiple of 16."""
    M, M2, O = fw["b1"].shape[0], fw["b2a"].shape[0], fw["b4"].shape[0]
    M2p = -(-M2 // 8) * 8
    w2a = F.pad(fw["w2a"].reshape(4 * M, M2).t(), (0, 0, 0, M2p - M2))
    w2b = F.pad(fw["w2b"], (0, 0, 0, M2p - M2)).reshape(4 * M2p, M).t()
    return torch.cat([_fragments(fw["w1"].reshape(27, M).t()), _fragments(w2a),
                      _fragments(w2b), _fragments(fw["w3"].reshape(18 * M, M).t()),
                      _fragments(fw["w4"].reshape(M, O).t())]).contiguous()


@torch.no_grad()
def fold_stem_weights(stem) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BN into each conv of a models.hgnetv2.StemBlock.

    Returns f32 tensors on the stem's device: HWIO kernels w1 [3,3,3,M]
    (carrying the 1/255 input normalisation, so the kernel reads raw pixels),
    w2a [2,2,M,M2], w2b [2,2,M2,M], w3 [3,3,2M,M], w4 [1,1,M,O]; biases
    b1..b4; lab [5,2] = (scale, bias) per conv, (1, 0) where there is no LAB;
    and "wtc", the same kernels rounded to bf16 for the fast kernel
    (`pack_fast_weights`), when M and O are multiples of 8.
    """
    out = {}
    lab = []
    for name in STEM_CONVS:
        m = getattr(stem, name)
        bn = m.bn
        t = bn.weight.float() / torch.sqrt(bn.running_var.float() + BN_EPS)
        w = m.conv.weight.float() * t[:, None, None, None]  # OIHW
        b = bn.bias.float() - bn.running_mean.float() * t
        tag = name[4:]
        if name == "stem1":
            w = w / 255.0
        out[f"w{tag}"] = w.permute(2, 3, 1, 0).contiguous()
        out[f"b{tag}"] = b.contiguous()
        if m.lab is not None:
            lab.append(torch.cat([m.lab.scale.float(), m.lab.bias.float()]))
        else:
            lab.append(torch.tensor([1.0, 0.0], device=w.device))
    out["lab"] = torch.stack(lab).contiguous()
    if out["b1"].shape[0] % 8 == 0 and out["b4"].shape[0] % 8 == 0:
        out["wtc"] = pack_fast_weights(out)
    return out


def stem_fwd_plain(x: torch.Tensor, fw: Dict[str, torch.Tensor],
                   fast: bool = False) -> torch.Tensor:
    """x uint8 [B, H, W, 3] raw pixels -> f32 [B, H/4, W/4, O], in plain
    PyTorch ops with the folded weights of `fold_stem_weights`. fast=True
    rounds each conv's input and weight to bf16 and convolves in f32."""
    lab = fw["lab"]
    rnd = (lambda t: t.to(torch.bfloat16).float()) if fast else (lambda t: t)

    def conv(h, tag, i, stride, pad):
        w = rnd(fw[f"w{tag}"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.relu(F.conv2d(rnd(h), w, fw[f"b{tag}"], stride=stride, padding=pad))
        return lab[i, 0] * y + lab[i, 1]

    h = x.permute(0, 3, 1, 2).float()
    f1 = F.pad(conv(h, "1", 0, 2, 1), (0, 1, 0, 1))
    x2 = conv(F.pad(conv(f1, "2a", 1, 1, 0), (0, 1, 0, 1)), "2b", 2, 1, 0)
    x1 = F.max_pool2d(f1, kernel_size=2, stride=1)
    y = conv(torch.cat([x1, x2], dim=1), "3", 3, 2, 1)
    return conv(y, "4", 4, 1, 0).permute(0, 2, 3, 1)


def _check_weights(x: torch.Tensor, fw: Dict[str, torch.Tensor], keys, fast: bool):
    M, M2, O = fw["b1"].shape[0], fw["b2a"].shape[0], fw["b4"].shape[0]
    shapes = {"w1": (3, 3, 3, M), "b1": (M,), "w2a": (2, 2, M, M2), "b2a": (M2,),
              "w2b": (2, 2, M2, M), "b2b": (M,), "w3": (3, 3, 2 * M, M), "b3": (M,),
              "w4": (1, 1, M, O), "b4": (O,), "lab": (5, 2)}
    for k in keys:
        t = fw[k]
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stem_fwd: {k} must be a contiguous f32 tensor on {x.device}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"stem_fwd: {k} has shape {tuple(t.shape)}, expected {shapes[k]}")
    if fast:
        if M % 8 or O % 8 or M2 % 2:
            raise ValueError(f"stem_fwd(fast=True): M and O must be multiples of 8 and M2 "
                             f"even, got {M}/{M2}/{O}")
        M2p = -(-M2 // 8) * 8
        n = 32 * M + 4 * M * M2p + 4 * M2p * M + 18 * M * M + O * (-(-M // 16) * 16)
        t = fw.get("wtc")
        if (t is None or t.device != x.device or t.dtype != torch.bfloat16
                or tuple(t.shape) != (n,) or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("stem_fwd(fast=True): fw['wtc'] must be pack_fast_weights(fw), "
                             f"a contiguous bf16 [{n}] tensor on {x.device}")
    elif M % 4 or M2 % 4 or O % 4:
        raise ValueError(f"stem_fwd: channel counts must be multiples of 4, got {M}/{M2}/{O}")
    return M, M2, O


def stem_fwd(x: torch.Tensor, fw: Dict[str, torch.Tensor], fast: bool = False) -> torch.Tensor:
    """Same signature and result as stem_fwd_plain, through the custom op
    `dfine_port::stem_fwd`: for CUDA tensors it launches csrc/stem_tc.cu
    (fast) or csrc/stem.cu (exact) and counts the launch in
    `stem_fwd.launches`, and a fast one also in `stem_fwd.fast_launches`.
    Requires H % 4 == 0 and W % 4 == 0; the output is NHWC, contiguous."""
    return torch.ops.dfine_port.stem_fwd(x, [fw[k] for k in WEIGHT_KEYS], fw.get("wtc"), fast)


stem_fwd.launches = 0
stem_fwd.fast_launches = 0


# The op takes the folded weights as a list in WEIGHT_KEYS order, so that
# torch.export can trace the serving graph through it (fake tensors have no
# data_ptr) and the exported artifact still launches the kernel.
@torch.library.custom_op("dfine_port::stem_fwd", mutates_args=(), device_types="cpu")
def _stem_op(x: torch.Tensor, weights: List[torch.Tensor], wtc: Optional[torch.Tensor],
             fast: bool) -> torch.Tensor:
    return stem_fwd_plain(x, dict(zip(WEIGHT_KEYS, weights)), fast).contiguous()


@_stem_op.register_fake
def _stem_fake(x, weights, wtc, fast):
    B, H, W, _ = x.shape
    return x.new_empty((B, H // 4, W // 4, weights[WEIGHT_KEYS.index("b4")].shape[0]),
                       dtype=torch.float32)


@_stem_op.register_kernel("cuda")
def _stem_cuda(x, weights, wtc, fast):
    from ._ext import load

    fw = dict(zip(WEIGHT_KEYS, weights))
    if wtc is not None:
        fw["wtc"] = wtc
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem_fwd: expected uint8 [B,H,W,3], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("stem_fwd: the image batch must be contiguous")
    if fast and x.data_ptr() % 4:  # the fast kernel copies 4-byte words
        raise ValueError("stem_fwd(fast=True): the image batch must be 4-byte aligned")
    B, H, W, _ = x.shape
    if H % 4 or W % 4:
        raise ValueError(f"stem_fwd: H and W must be multiples of 4, got {H}x{W}")
    M, M2, O = _check_weights(x, fw, BIAS_KEYS if fast else WEIGHT_KEYS, fast)
    out = torch.empty((B, H // 4, W // 4, O), dtype=torch.float32, device=x.device)
    if fast:
        fn = load("stem_tc").stem_tc_fwd
        ptrs = [fw["wtc"].data_ptr()] + [fw[k].data_ptr() for k in BIAS_KEYS]
    else:
        fn = load("stem").stem_fwd
        ptrs = [fw[k].data_ptr() for k in WEIGHT_KEYS]
    fn.argtypes = [ctypes.c_void_p] * (2 + len(ptrs)) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), *ptrs, B, H, W, M, M2, O,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_fwd: kernel launch failed with CUDA error {err}")
    stem_fwd.launches += 1
    stem_fwd.fast_launches += int(fast)
    return out
