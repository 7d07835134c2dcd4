#!/usr/bin/env python3
"""Drive the PyTorch port's D-FINE-m serving, training and Trainer paths on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --checks-only   # build + kernel checks only
    python3 chip_smoke.py --report out/chip_smoke.json   # also write the details

Phases, in order; each raises on failure, and the script then exits non-zero
without printing its final line:
  1. device: a CUDA card is required; prints nvidia-smi's name and power limit.
  2. build: compiles every kernel of csrc/ with nvcc, one process per source.
  3. kernel checks at the shapes of the path that runs each kernel, TF32 off:
     each kernel against its plain PyTorch version on the same inputs, then
     timed beside its plain version and a PyTorch library formulation where
     one exists (device time from the profiler's device events; CUDA events
     over back-to-back calls as a second reading), with its bound on the card.
     The stem in both modes (exact f32; fast: bf16 operands on the tensor
     cores, as served) and the MSDA forward at the serving shapes (plus 36
     points on 4 levels, and c = 6, 36 and 160), the MSDA forward and
     backward at the training shapes (B = 2 and 16, 500 queries, f32 and
     bf16 values, plus a level wider than one shared-memory slab).
  4. serving: build_serving("m", 80, (640, 640)) with the port's own random
     init; serves uint8 batches at bs1 and bs4 with every launch counter set
     to 0 just before and read just after; checks the detections; compares
     bs1 detections with the same forward on a CPU copy of the model (all
     f32, and in the served modes: fast stem, bf16 MSDA value); times
     serving ms/img at bs1 and bs16 with TF32 off, as PyTorch defaults it
     (convolutions only) and fully on; profiles bs1 requests for the device's
     busy time and idle share.
  5. training: build_training("m", 80) (bf16 autocast, the Trainer's default)
     takes warm-up steps on a bs16 640^2 uint8 batch with 12 GT boxes per
     image, then timed steps with every launch counter set to 0 just before
     and read just after (4 MSDA forward and 4 backward launches per step, no
     stem); checks the loss terms; profiles steps for the device's busy time
     and idle share; compares one f32 step (TF32 off, bs2 at 320^2) with the
     same step on a CPU copy.
  6. trainer: the port's Trainer (train/trainer.py) on a synthetic YOLO set
     of 64 train and 16 val JPEGs: one epoch of D-FINE-m at 640^2, bs16,
     bf16, EMA on, mosaic and multiscale, 4 loader threads, in a process
     group of world size 1 on NCCL (parallel/dist.py), then eval on the EMA
     and checkpoints; every launch counter set to 0 just before train() and
     read just after (4 MSDA forward launches per step and eval batch, 4
     backward per step, no stem); checks the loss, the parameters and the
     metrics' keys; a second Trainer loads `last` and must hold the model,
     EMA and AdamW state exactly. Prints the epoch's wall time, the img/s
     inside the Trainer beside phase 5's, the share of the epoch spent
     waiting on the loader, the eval's wall time and which mAP matcher ran.
Each profile also gives the device time per launch of each of the port's
own kernels on that path, wherever it ranks.
Prints a {"kernels": [...]} line, the card's line, and last
{"ok": true, "device": {...}}. --report writes every reading to a JSON file.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the tensor cores,
# dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
STEM_FAST_TOL = 1e-2  # fast stem vs its plain version, scaled by the output's largest entry
SERVED_SAME_TOL = 2e-3  # as served on the card vs the CPU in the same modes (phase 4)

# the port's kernels by name, as the profiler reports them
PORT_KERNELS = re.compile(r"\b(msda_fwd_kernel|msda_bwd_dloc_kernel|msda_bwd_dvalue_kernel|"
                          r"stem_kernel|stem_tc_kernel)\b")

IMG = (640, 640)
SHAPES = [(80, 80), (40, 40), (20, 20)]  # MSDA levels of D-FINE-m at 640^2
POINTS = [3, 6, 3]
LQ, HEADS, CH = 300, 8, 32
LQ_TRAIN = 500  # 300 queries + 2 denoising groups x 2 x 50 slots


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Median over `repeats` of the mean device time of `iters` calls (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


def device_spans(fn, n: int):
    """Run fn n times under torch.profiler; its device events (kernels,
    copies, fills) as (name, start_ns, duration_ns). User annotations
    (record_function ranges that the profiler mirrors on the device's
    timeline, such as the optimizer's step) are not device work and are left
    out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
            and not getattr(e, "is_user_annotation", lambda: False)()]


def busy_ms(spans) -> float:
    """Time the device was running any of `spans` (the union of intervals), ms."""
    busy_ns, end = 0, None
    for _, a, d in sorted(spans, key=lambda s: s[1]):
        b = a + d
        if end is None or a > end:
            busy_ns += d
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    return busy_ns / 1e6


def time_call(fn, iters: int = 20) -> dict:
    """A call's device time (its device events, from the profiler, per call)
    and its CUDA-event time over back-to-back calls, which also counts the gaps
    while the host enqueues the next call. "ms" is the device time; the event
    time stands in for it only when the profiler records no device events."""
    events = cuda_ms(fn, iters=iters)
    try:
        spans = device_spans(fn, iters)
    except RuntimeError as e:
        log(f"[time] profiler failed ({e}); using CUDA-event time")
        spans = []
    device = busy_ms(spans) / iters if spans else None
    return {"ms": device if device is not None else events, "device_ms": device,
            "cuda_events_ms": events}


def host_ms(fn, iters: int = 10, warmup: int = 3) -> dict:
    """Wall time of one call that ends in torch.cuda.synchronize() (ms):
    median, quartiles and, from 100 samples on, the 90th percentile (the
    highest with at least ten samples beyond it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(times, n=20)  # q[4] = p25, q[14] = p75, q[17] = p90
    out = {"n": iters, "median": statistics.median(times), "p25": q[4], "p75": q[14]}
    if iters >= 100:
        out["p90"] = q[17]
    return out


def events_by_name(torch, fn, n: int = 10):
    """The device events of one call of fn, by kernel name: ms and count per
    call, averaged over n calls (an empty list when the profiler records
    none)."""
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for name, _, d in device_spans(fn, n):
        t, c = by_name.get(name, (0, 0))
        by_name[name] = (t + d, c + 1)
    return [{"kernel": k[:120], "ms": t / 1e6 / n, "calls": c / n}
            for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])]


def bound(bytes_: float, flops: float, peak_ops: float = PEAK_F32):
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1
def phase_device(report):
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    return card


# ---------------------------------------------------------------- phase 2
def phase_build(report, verbose):
    from custom_d_fine_tpu_torch.ops import _ext

    secs = _ext.build_all(verbose=verbose)
    report["build_s"] = secs
    log(f"[build] nvcc {', '.join(_ext.SOURCES)} -> {_ext.build_dir()} in {secs:.2f} s")


# ---------------------------------------------------------------- phase 3
def stem_work(B, H, W, M, M2, O):
    H2, W2, H4, W4 = H // 2, W // 2, H // 4, W // 4
    macs = (H2 * W2 * M * 27 + H2 * W2 * M2 * 4 * M + H2 * W2 * M * 4 * M2
            + H4 * W4 * M * 9 * 2 * M + H4 * W4 * O * M)
    weights = 27 * M + 4 * M * M2 * 2 + 9 * 2 * M * M + M * O + 3 * M + M2 + O + 10
    return B * H * W * 3 + B * H4 * W4 * O * 4 + weights * 4, 2.0 * B * macs


def sass_count(lib_name: str, opcode: str) -> int:
    """Instructions of `opcode` in a built library's SASS (cuobjdump -sass),
    or -1 when the toolkit has no cuobjdump."""
    import shutil

    from custom_d_fine_tpu_torch.ops import _ext

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return -1
    sass = subprocess.run([tool, "-sass", str(_ext.build_dir() / f"lib{lib_name}.so")],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    return sum(1 for line in sass.splitlines() if opcode in line)


def check_stem(torch, report):
    """Both modes against the plain version on the same weights and bytes, at
    B = 1 and 2, 640^2: exact at atol 2e-5, fast at STEM_FAST_TOL of the
    output's largest entry (a bf16 intermediate may round the other way when
    its f32 sum is taken in another order). Timed at bs1, as serving calls it."""
    from custom_d_fine_tpu_torch.models.hgnetv2 import StemBlock
    from custom_d_fine_tpu_torch.ops.stem import fold_stem_weights, stem_fwd, stem_fwd_plain

    g = torch.Generator().manual_seed(1)
    stem = StemBlock(3, 24, 32, use_lab=True).eval()  # the B2 stem of D-FINE-m
    with torch.no_grad():
        for m in stem.modules():  # non-trivial BN statistics and LAB scalars
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            if hasattr(m, "scale") and isinstance(m.scale, torch.nn.Parameter):
                m.scale.fill_(1.1)
                m.bias.fill_(-0.05)
    fw = fold_stem_weights(stem.cuda())
    err = {False: 0.0, True: 0.0}
    fast_scaled = 0.0
    for B in (1, 2):
        x = torch.randint(0, 256, (B, *IMG, 3), dtype=torch.uint8, generator=g).cuda()
        for fast in (False, True):
            got = stem_fwd(x, fw, fast)
            torch.cuda.synchronize()
            want = stem_fwd_plain(x, fw, fast)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err[fast] = max(err[fast], e)
            if fast:
                scaled = e / want.abs().max().item()
                fast_scaled = max(fast_scaled, scaled)
                rounding = (got - exact).abs().max().item() / exact.abs().max().item()
                log(f"[stem] fast B={B} {tuple(got.shape)} max_abs_err={e:.3e}, scaled "
                    f"{scaled:.3e} ({STEM_FAST_TOL:g}); fast vs exact kernel, scaled: "
                    f"{rounding:.3e}")
                ok = scaled <= STEM_FAST_TOL
            else:
                exact = got
                log(f"[stem] exact B={B} {tuple(got.shape)} max_abs_err={e:.3e} (atol 2e-5)")
                ok = e <= 2e-5
            if not (torch.isfinite(got).all() and ok):
                raise AssertionError(f"stem kernel (fast={fast}) disagrees with its plain "
                                     f"version: {e}")
    hmma = sass_count("stem_tc", "HMMA")
    log(f"[stem] cuobjdump -sass libstem_tc.so: {hmma} HMMA instructions"
        + (" (cuobjdump not found: not checked)" if hmma < 0 else ""))
    if hmma == 0:
        raise AssertionError("the fast stem kernel has no tensor-core (HMMA) instruction")
    x = torch.randint(0, 256, (1, *IMG, 3), dtype=torch.uint8, generator=g).cuda()
    bytes_, flops = stem_work(1, *IMG, 24, 12, 32)
    modes = {}
    for name, fast, peak in (("fast", True, PEAK_BF16), ("exact", False, PEAK_F32)):
        t_k = time_call(lambda: stem_fwd(x, fw, fast))
        t_p = time_call(lambda: stem_fwd_plain(x, fw, fast))
        b_ms, b_by = bound(bytes_, flops, peak)
        modes[name] = dict(ms=t_k["ms"], plain_ms=t_p["ms"], bound_ms=b_ms, bound_by=b_by,
                           cuda_events_ms=t_k["cuda_events_ms"],
                           plain_cuda_events_ms=t_p["cuda_events_ms"])
        log(f"[stem] {name} bs1 device time: kernel {t_k['ms']:.4f} ms | plain "
            f"{t_p['ms']:.4f} ms (CUDA events over back-to-back calls: "
            f"{t_k['cuda_events_ms']:.4f} | {t_p['cuda_events_ms']:.4f}) | bound "
            f"{b_ms * 1e3:.2f} us ({b_by}) | library: none (no single PyTorch call is the stem)")
    f, ex = modes["fast"], modes["exact"]
    row = {"name": "stem_fwd", "route": "cuda",
           "source": "custom_d_fine_tpu_torch/csrc/stem_tc.cu",
           "replaces": "custom_d_fine_tpu/ops/pallas/stem.py:104",
           "tpu_kernels": ["custom_d_fine_tpu/ops/pallas/stem.py:104 _stem_kernel"],
           "max_abs_err": err[True], "max_scaled_err": fast_scaled, "ms": f["ms"],
           "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
           "library_ms": None, "shape": "B=1 640x640x3 uint8 -> f32, fast mode (served)",
           "cuda_events_ms": f["cuda_events_ms"],
           "plain_cuda_events_ms": f["plain_cuda_events_ms"], "hmma_instructions": hmma,
           "exact": {"source": "custom_d_fine_tpu_torch/csrc/stem.cu",
                     "max_abs_err": err[False], **ex}}
    report["stem_calls"] = row
    return row


def msda_inputs(torch, B, g, dtype, Lq=LQ):
    Lv = sum(h * w for h, w in SHAPES)
    P = sum(POINTS)
    value = torch.randn(B, Lv, HEADS, CH, generator=g).to(dtype)
    loc = torch.rand(B, Lq, HEADS, P, 2, generator=g) * 1.2 - 0.1
    loc[0, 0, 0, 0] = torch.tensor([0.0, 0.0])     # corners and edges
    loc[0, 1, 0, 0] = torch.tensor([1.0, 1.0])
    loc[0, 2, 1, 3] = torch.tensor([-0.2, 0.5])    # partly out
    loc[0, 3, 2, 5] = torch.tensor([0.999, 0.001])
    loc[-1, 4, 3, -1] = torch.tensor([7.5, -3.0])  # far out of range
    attn = torch.softmax(torch.randn(B, Lq, HEADS, P, generator=g), dim=-1)
    return value.cuda().contiguous(), loc.cuda().contiguous(), attn.cuda().contiguous()


def msda_rows(torch, value, loc):
    """The value rows that valid corners touch (unique, counted once) and the
    number of valid corners: what this data needs of the value map."""
    B, Lv, h, c = value.shape
    keys, n_valid, p_off, start = [], 0, 0, 0
    bidx = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    hidx = torch.arange(h, device=loc.device).view(1, 1, h, 1)
    for (H, W), P in zip(SHAPES, POINTS):
        lp = loc[:, :, :, p_off:p_off + P]
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
    return torch.unique(torch.cat(keys)).numel(), n_valid


def msda_work(torch, value, loc, attn):
    """Bytes and flops this data needs: each value row that a valid corner
    touches, read once; loc/attn read once; out written once. Also the bytes
    of all valid corners' rows, each counted every time a corner loads it."""
    B, Lv, h, c = value.shape
    n_rows, n_valid = msda_rows(torch, value, loc)
    bytes_ = (n_rows * c * value.element_size() + loc.numel() * 4 + attn.numel() * 4
              + B * loc.shape[1] * h * c * 4)
    flops = c * (2 * n_valid + 2 * attn.numel())
    return bytes_, flops, n_rows, n_valid * c * value.element_size()


def msda_bwd_work(torch, value, loc, attn):
    """Bytes and flops the backward needs on this data: the touched value
    rows, loc, attn and grad_out read once; dvalue (value's dtype, every
    position), dloc and dattn written once. Per valid corner and channel:
    the dvalue term (2 flops), the three <g, .> sums (2 each) and the
    corner's weight and differences (~4): 12 flops."""
    B, Lv, h, c = value.shape
    n_rows, n_valid = msda_rows(torch, value, loc)
    Lq = loc.shape[1]
    bytes_ = (n_rows * c * value.element_size() + 2 * (loc.numel() * 4 + attn.numel() * 4)
              + B * Lq * h * c * 4 + value.numel() * value.element_size())
    return bytes_, 12 * c * n_valid, n_rows


def msda_grid_sample(torch, value, loc, attn):
    """The original torch repo's formulation (F.grid_sample per level,
    src/d_fine/arch/utils.py:191-264): a yardstick only, never used by the port."""
    import torch.nn.functional as F

    B, Lv, h, c = value.shape
    Lq = loc.shape[1]
    out, v_off, p_off = 0, 0, 0
    for (H, W), P in zip(SHAPES, POINTS):
        v = value[:, v_off:v_off + H * W].permute(0, 2, 3, 1).reshape(B * h, c, H, W)
        grid = (2 * loc[:, :, :, p_off:p_off + P] - 1).permute(0, 2, 1, 3, 4)
        s = F.grid_sample(v, grid.reshape(B * h, Lq, P, 2).to(v.dtype), mode="bilinear",
                          padding_mode="zeros", align_corners=False)  # [B*h, c, Lq, P]
        a = attn[:, :, :, p_off:p_off + P].permute(0, 2, 1, 3).reshape(B * h, 1, Lq, P)
        out = out + (s.float() * a).sum(-1)
        v_off += H * W
        p_off += P
    return out.reshape(B, h, c, Lq).permute(0, 3, 1, 2).reshape(B, Lq, h * c)


def check_msda(torch, report):
    """msda_fwd against msda_fwd_plain at the serving shapes (B = 1 and 4,
    300 queries) and the training step's (B = 16, 500 queries), with f32 and
    bf16 value maps; timed at bs1 as serving calls it."""
    from custom_d_fine_tpu_torch.ops.msda import level_start_index, msda_fwd, msda_fwd_plain

    g = torch.Generator().manual_seed(2)
    starts = level_start_index(SHAPES)
    errs = {}
    for B, Lq in ((1, LQ), (4, LQ), (16, LQ_TRAIN)):  # serving, then the training step's
        v32, loc, attn = msda_inputs(torch, B, g, torch.float32, Lq=Lq)
        got = msda_fwd(v32, SHAPES, starts, loc, attn, POINTS)
        torch.cuda.synchronize()
        want = msda_fwd_plain(v32, SHAPES, starts, loc, attn, POINTS)
        torch.cuda.synchronize()
        e32 = (got - want).abs().max().item()
        ok32 = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        v16 = v32.to(torch.bfloat16)
        got16 = msda_fwd(v16, SHAPES, starts, loc, attn, POINTS)
        torch.cuda.synchronize()
        same16 = msda_fwd_plain(v16, SHAPES, starts, loc, attn, POINTS)
        torch.cuda.synchronize()
        e16 = (got16 - same16).abs().max().item()
        scale = max(want.abs().max().item(), 1e-6)
        e16_f32 = (got16 - want).abs().max().item() / scale
        lib = msda_grid_sample(torch, v32, loc, attn)
        elib = (lib - want).abs().max().item()
        log(f"[msda] B={B} Lq={Lq} f32 max_abs_err={e32:.3e} (rtol=atol=1e-5) | bf16 value: "
            f"vs plain on the same bf16 {e16:.3e} (1e-5), vs f32 scaled {e16_f32:.3e} "
            f"(0.02) | grid_sample formulation vs plain {elib:.3e}")
        if not (ok32 and e16 <= 1e-5 and e16_f32 <= 0.02 and torch.isfinite(got).all()):
            raise AssertionError(f"msda kernel disagrees with its plain version: "
                                 f"{e32}, {e16}, {e16_f32}")
        errs[(B, Lq)] = (e32, e16)
    # the kernel's other branches, f32 and bf16 value maps, at the serving
    # shapes: more than 32 points an item (prepared 32 at a time, one item a
    # warp); c = 6 (no 16-byte channel vectors: one channel a lane); more
    # channel groups than a warp's lanes, which loop: c = 36 (bf16 one channel
    # a lane, 36 groups) and c = 160 (f32 40 groups of 4)
    for label, shapes, points, c in (("Ptot=36 on 4 levels", SHAPES + [(10, 10)],
                                      [12, 12, 8, 4], CH),
                                     ("c=6", SHAPES, POINTS, 6),
                                     ("c=36", SHAPES, POINTS, 36),
                                     ("c=160", SHAPES, POINTS, 160)):
        st = level_start_index(shapes)
        Lv, P = sum(h * w for h, w in shapes), sum(points)
        v32 = torch.randn(2, Lv, HEADS, c, generator=g).cuda()
        loc = (torch.rand(2, LQ, HEADS, P, 2, generator=g) * 1.2 - 0.1).cuda()
        attn = torch.softmax(torch.randn(2, LQ, HEADS, P, generator=g), dim=-1).cuda()
        e = []
        for v in (v32, v32.to(torch.bfloat16)):
            got = msda_fwd(v, shapes, st, loc, attn, points)
            torch.cuda.synchronize()
            want = msda_fwd_plain(v, shapes, st, loc, attn, points)
            torch.cuda.synchronize()
            e.append((got - want).abs().max().item())
            if not (torch.allclose(got, want, rtol=1e-5, atol=1e-5) and torch.isfinite(got).all()):
                raise AssertionError(f"msda kernel ({label}, {v.dtype}) disagrees with its plain "
                                     f"version: {e[-1]}")
        log(f"[msda] B=2 Lq={LQ} {label}: f32 max_abs_err={e[0]:.3e}, bf16 value vs plain on "
            f"the same bf16 {e[1]:.3e} (rtol=atol=1e-5)")
        errs[label] = tuple(e)
    # timing at the serving path's shapes: bs1, bf16 value as serving passes it
    v32, loc, attn = msda_inputs(torch, 1, g, torch.float32)
    v16 = v32.to(torch.bfloat16)
    rows = {}
    for name, v in (("bf16", v16), ("f32", v32)):
        t_k = time_call(lambda: msda_fwd(v, SHAPES, starts, loc, attn, POINTS), iters=50)
        t_p = time_call(lambda: msda_fwd_plain(v, SHAPES, starts, loc, attn, POINTS))
        try:
            t_l = time_call(lambda: msda_grid_sample(torch, v, loc, attn))
        except RuntimeError as e:  # grid_sample without this dtype on this build
            log(f"[msda] grid_sample on {name} value failed ({e}); library_ms null")
            t_l = {"ms": None, "cuda_events_ms": None}
        bytes_, flops, n_rows, corner_bytes = msda_work(torch, v, loc, attn)
        b_ms, b_by = bound(bytes_, flops)
        rows[name] = dict(ms=t_k["ms"], plain_ms=t_p["ms"], library_ms=t_l["ms"],
                          bound_ms=b_ms, bound_by=b_by, bytes=bytes_, flops=flops,
                          value_rows=n_rows, corner_row_bytes=corner_bytes,
                          cuda_events_ms=t_k["cuda_events_ms"],
                          plain_cuda_events_ms=t_p["cuda_events_ms"],
                          library_cuda_events_ms=t_l["cuda_events_ms"])
        lib = "n/a" if t_l["ms"] is None else "%.4f" % t_l["ms"]
        lib_ev = "n/a" if t_l["ms"] is None else "%.4f" % t_l["cuda_events_ms"]
        log(f"[msda] bs1 {name} value, device time: kernel {t_k['ms']:.4f} ms | plain "
            f"{t_p['ms']:.4f} ms | grid_sample {lib} ms (CUDA events over back-to-back calls: "
            f"{t_k['cuda_events_ms']:.4f} | {t_p['cuda_events_ms']:.4f} | {lib_ev}) | bound "
            f"{b_ms * 1e3:.2f} us ({b_by}; {bytes_ / 1e6:.2f} MB, {n_rows} value rows); every "
            f"valid corner's row: {corner_bytes / 1e6:.2f} MB")
    # the training step's shapes: bs16, 500 queries, bf16 value (4 calls a step)
    v32, loc, attn = msda_inputs(torch, 16, g, torch.float32, Lq=LQ_TRAIN)
    v = v32.to(torch.bfloat16)
    t_k = time_call(lambda: msda_fwd(v, SHAPES, starts, loc, attn, POINTS))
    t_p = time_call(lambda: msda_fwd_plain(v, SHAPES, starts, loc, attn, POINTS), iters=5)
    try:
        t_l = time_call(lambda: msda_grid_sample(torch, v, loc, attn))
    except RuntimeError as e:
        log(f"[msda] grid_sample on a bf16 value failed ({e}); library_ms null")
        t_l = {"ms": None, "cuda_events_ms": None}
    bytes_, flops, n_rows, corner_bytes = msda_work(torch, v, loc, attn)
    b_ms, b_by = bound(bytes_, flops)
    rows["train_bf16"] = dict(ms=t_k["ms"], plain_ms=t_p["ms"], library_ms=t_l["ms"],
                              bound_ms=b_ms, bound_by=b_by, bytes=bytes_, flops=flops,
                              value_rows=n_rows, corner_row_bytes=corner_bytes,
                              cuda_events_ms=t_k["cuda_events_ms"])
    lib = "n/a" if t_l["ms"] is None else "%.4f" % t_l["ms"]
    log(f"[msda] bs16 Lq={LQ_TRAIN} bf16 value (training), device time: kernel "
        f"{t_k['ms']:.4f} ms | plain {t_p['ms']:.4f} ms | grid_sample {lib} ms | bound "
        f"{b_ms * 1e3:.2f} us ({b_by}; {bytes_ / 1e6:.2f} MB, {n_rows} value rows); every "
        f"valid corner's row: {corner_bytes / 1e6:.2f} MB; corner-row bytes / kernel time "
        f"{corner_bytes / t_k['ms'] / 1e9:.2f} TB/s")
    report["msda_calls"] = rows
    r, rt = rows["bf16"], rows["train_bf16"]
    return {"name": "msda_fwd", "route": "cuda",
            "source": "custom_d_fine_tpu_torch/csrc/msda.cu",
            "replaces": "custom_d_fine_tpu/ops/pallas/msda_sep.py:69",
            "tpu_kernels": ["custom_d_fine_tpu/ops/pallas/msda_sep.py:69 _sep_kernel",
                            "custom_d_fine_tpu/ops/pallas/msda.py:84 _level_kernel",
                            "custom_d_fine_tpu/ops/pallas/msda_sep.py:119 _sep_kernel_psum"],
            "max_abs_err": max(max(e) for e in errs.values()), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": "B=1 Lq=300 8x32 levels 80/40/20 points 3/6/3, bf16 value",
            "checked_shapes": "B=1 and 4 at Lq=300, B=16 at Lq=500; B=2 Lq=300 with 36 points "
                              "on 4 levels and with c=6, 36, 160; f32 and bf16 value",
            "cuda_events_ms": r["cuda_events_ms"], "plain_cuda_events_ms": r["plain_cuda_events_ms"],
            "library_cuda_events_ms": r["library_cuda_events_ms"],
            "train": {"shape": "B=16 Lq=500, bf16 value", **rt}}


def check_msda_bwd(torch, report):
    """msda_bwd against msda_bwd_plain at the training shapes (B = 2 and 16,
    500 queries), f32 and bf16 value maps; timed at bs16 with a bf16 value
    map, as the bf16 training step gives it. Errors are scaled by the
    largest entry of each gradient: 1e-5 for f32 sums in another order (dvalue
    through atomics), 8e-3 for a bf16 dvalue (one bf16 rounding of the same
    f32 sum)."""
    from custom_d_fine_tpu_torch.ops.msda import level_start_index, msda_bwd, msda_bwd_plain

    g = torch.Generator().manual_seed(4)
    starts = level_start_index(SHAPES)
    worst, worst_scaled = 0.0, 0.0
    for B in (2, 16):
        for dtype in (torch.float32, torch.bfloat16):
            v, loc, attn = msda_inputs(torch, B, g, dtype, Lq=LQ_TRAIN)
            grad = torch.randn(B, LQ_TRAIN, HEADS * CH, generator=g).cuda()
            got = msda_bwd(v, SHAPES, starts, loc, attn, grad, POINTS)
            torch.cuda.synchronize()
            want = msda_bwd_plain(v, SHAPES, starts, loc, attn, grad, POINTS)
            torch.cuda.synchronize()
            msg = []
            for name, a, b in zip(("dvalue", "dloc", "dattn"), got, want):
                a, b = a.float(), b.float()
                e = (a - b).abs().max().item()
                scaled = e / max(b.abs().max().item(), 1e-6)
                tol = 8e-3 if (name == "dvalue" and dtype == torch.bfloat16) else 1e-5
                if not (torch.isfinite(a).all() and scaled <= tol):
                    raise AssertionError(f"msda_bwd {name} (B={B}, {dtype}) disagrees with its "
                                         f"plain version: max_abs_err {e}, scaled {scaled}")
                worst, worst_scaled = max(worst, e), max(worst_scaled, scaled)
                msg.append(f"{name} {e:.3e} (scaled {scaled:.2e}, tol {tol:g})")
            log(f"[msda_bwd] B={B} Lq={LQ_TRAIN} {str(dtype)[6:]} value: " + " | ".join(msg))
    # a level whose single row does not fit one CTA's shared-memory slab (800
    # positions of 32 channels): rectangles of part of a row
    shapes, points = [(3, 1000), (40, 40)], [4, 2]
    for dtype in (torch.float32, torch.bfloat16):
        Lv, P = sum(h * w for h, w in shapes), sum(points)
        v = torch.randn(2, Lv, 2, CH, generator=g).to(dtype).cuda()
        loc = (torch.rand(2, 100, 2, P, 2, generator=g) * 1.2 - 0.1).cuda()
        attn = torch.rand(2, 100, 2, P, generator=g).cuda()
        grad = torch.randn(2, 100, 2 * CH, generator=g).cuda()
        st = level_start_index(shapes)
        got = msda_bwd(v, shapes, st, loc, attn, grad, points)
        torch.cuda.synchronize()
        want = msda_bwd_plain(v, shapes, st, loc, attn, grad, points)
        for name, a, b in zip(("dvalue", "dloc", "dattn"), got, want):
            a, b = a.float(), b.float()
            e = (a - b).abs().max().item()
            scaled = e / max(b.abs().max().item(), 1e-6)
            tol = 8e-3 if (name == "dvalue" and dtype == torch.bfloat16) else 1e-5
            if not (torch.isfinite(a).all() and scaled <= tol):
                raise AssertionError(f"msda_bwd {name} on a 3x1000 level ({dtype}) disagrees "
                                     f"with its plain version: scaled {scaled}")
            worst, worst_scaled = max(worst, e), max(worst_scaled, scaled)
        log(f"[msda_bwd] levels 3x1000 + 40x40 (rows wider than a slab), {str(dtype)[6:]} "
            f"value: within tolerance")
    v, loc, attn = msda_inputs(torch, 16, g, torch.bfloat16, Lq=LQ_TRAIN)
    grad = torch.randn(16, LQ_TRAIN, HEADS * CH, generator=g).cuda()
    t_k = time_call(lambda: msda_bwd(v, SHAPES, starts, loc, attn, grad, POINTS))
    t_p = time_call(lambda: msda_bwd_plain(v, SHAPES, starts, loc, attn, grad, POINTS), iters=5)
    try:  # the backward of the grid_sample formulation: a yardstick the port never calls
        leaves = [t.detach().clone().requires_grad_() for t in (v, loc, attn)]
        out = msda_grid_sample(torch, *leaves)
        t_l = time_call(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))
    except RuntimeError as e:
        log(f"[msda_bwd] grid_sample backward on a bf16 value failed ({e}); library_ms null")
        t_l = {"ms": None, "cuda_events_ms": None}
    events = events_by_name(torch, lambda: msda_bwd(v, SHAPES, starts, loc, attn, grad, POINTS))
    for e in events:
        log(f"[msda_bwd]   device event {e['ms']:.4f} ms x{e['calls']:g}  {e['kernel'][:90]}")
    foreign = [e["kernel"] for e in events if "msda_bwd_" not in e["kernel"]]
    if foreign:  # the wrapper allocates with torch.empty: no fill, no cast
        raise AssertionError(f"msda_bwd ran device work besides its kernels: {foreign}")
    bytes_, flops, n_rows = msda_bwd_work(torch, v, loc, attn)
    b_ms, b_by = bound(bytes_, flops)
    lib = "n/a" if t_l["ms"] is None else "%.4f" % t_l["ms"]
    log(f"[msda_bwd] bs16 bf16 value, device time: kernel {t_k['ms']:.4f} ms | plain "
        f"{t_p['ms']:.4f} ms | grid_sample backward {lib} ms (CUDA events over back-to-back "
        f"calls: {t_k['cuda_events_ms']:.4f} | {t_p['cuda_events_ms']:.4f}) | bound "
        f"{b_ms * 1e3:.2f} us ({b_by}; {bytes_ / 1e6:.2f} MB, {n_rows} value rows)")
    row = {"name": "msda_bwd", "route": "cuda",
           "source": "custom_d_fine_tpu_torch/csrc/msda_bwd.cu",
           "replaces": "custom_d_fine_tpu/ops/pallas/msda_sep.py:248",
           "tpu_kernels": ["custom_d_fine_tpu/ops/pallas/msda_sep.py:248 _sep_bwd_kernel",
                           "custom_d_fine_tpu/ops/pallas/msda.py:181 _level_bwd_kernel"],
           "max_abs_err": worst, "max_scaled_err": worst_scaled, "ms": t_k["ms"],
           "plain_ms": t_p["ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l["ms"],
           "shape": "B=16 Lq=500 8x32 levels 80/40/20 points 3/6/3, bf16 value",
           "bytes": bytes_, "flops": flops, "value_rows": n_rows, "device_events": events,
           "cuda_events_ms": t_k["cuda_events_ms"],
           "plain_cuda_events_ms": t_p["cuda_events_ms"],
           "library_cuda_events_ms": t_l["cuda_events_ms"]}
    report["msda_bwd_calls"] = row
    return row


# ---------------------------------------------------------------- phase 4
def detections_ok(det, bs, num_classes=80):
    import torch

    s, l, b = det["scores"], det["labels"], det["boxes"]
    assert s.shape == (bs, 300) and l.shape == (bs, 300) and b.shape == (bs, 300, 4), \
        {k: tuple(v.shape) for k, v in det.items()}
    assert torch.isfinite(s).all() and torch.isfinite(b).all(), "non-finite detections"
    assert ((s >= 0) & (s <= 1)).all(), "scores outside [0, 1]"
    assert ((l >= 0) & (l < num_classes)).all(), "labels out of range"


def compare_detections(got, want, img, tol=1e-4):
    """The slice test's rule: scores at atol tol; labels and boxes (pixels,
    atol tol x image size) where a score stands > tol from its neighbours."""
    import numpy as np

    gs, ws = got["scores"].cpu().numpy(), want["scores"].cpu().numpy()
    err = float(np.abs(gs - ws).max())
    n_keep = 0
    for b in range(gs.shape[0]):
        keep = np.ones(gs.shape[1], bool)
        for s in (gs[b], ws[b]):
            d = np.abs(np.diff(s)) > tol
            keep[:-1] &= d
            keep[1:] &= d
        n_keep += int(keep.sum())
        if not (got["labels"][b].cpu().numpy()[keep] == want["labels"][b].cpu().numpy()[keep]).all():
            raise AssertionError("labels differ on tie-robust detections")
        bd = np.abs(got["boxes"][b].cpu().numpy()[keep] - want["boxes"][b].cpu().numpy()[keep])
        if bd.size and bd.max() > tol * max(img):
            raise AssertionError(f"boxes differ on tie-robust detections: {bd.max()}")
    if err > tol:
        raise AssertionError(f"scores differ: {err}")
    return err, n_keep


def phase_serving(torch, report):
    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.deploy.reparam import convert_to_deploy
    from custom_d_fine_tpu_torch.deploy.serving import build_serving, make_serving_forward
    from custom_d_fine_tpu_torch.models.dfine import build_model
    from custom_d_fine_tpu_torch.ops.msda import msda_fwd
    from custom_d_fine_tpu_torch.ops.stem import stem_fwd

    t0 = time.perf_counter()
    fn, model = build_serving("m", 80, IMG, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] build_serving('m', 80, {IMG}) on {next(model.parameters()).device} "
        f"in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(3)
    batches = {bs: torch.randint(0, 256, (bs, *IMG, 3), dtype=torch.uint8, generator=g).cuda()
               for bs in (1, 4, 16)}

    # ---- the main path: counts set to 0 just before, read just after
    stem_fwd.launches = stem_fwd.fast_launches = 0
    msda_fwd.launches = 0
    n_fwd = 0
    for bs in (1, 4):
        for _ in range(2):
            det = fn(batches[bs])
            n_fwd += 1
            detections_ok(det, bs)
    torch.cuda.synchronize()
    launches = {"stem_fwd": stem_fwd.launches, "msda_fwd": msda_fwd.launches}
    n_fast = stem_fwd.fast_launches
    log(f"[serve] {n_fwd} forwards (bs1 x2, bs4 x2): launches {launches}, of which "
        f"{n_fast} of the stem in its fast mode; top score {det['scores'].max().item():.4f}")
    n_layers = get_model_config("m").decoder.num_layers
    if launches != {"stem_fwd": n_fwd, "msda_fwd": n_layers * n_fwd} or n_fast != n_fwd:
        raise AssertionError(f"expected {n_fwd} fast stem and {n_layers * n_fwd} MSDA "
                             f"launches, got {launches}, {n_fast} fast")
    report["launches_serving"] = dict(launches, stem_fwd_fast=n_fast)

    # ---- the same forward on a CPU copy. Conv kernels x sqrt(6) (kaiming
    # scale): with torch's default scale a random model's features fade
    # through ~40 conv layers and its 8400 query-selection scores tie to
    # ~1e-6, which would compare rounding, not the port.
    ref = build_model(get_model_config("m"), num_classes=80, seed=1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(math.sqrt(6.0))
    convert_to_deploy(ref)
    cpu_fn = make_serving_forward(copy.deepcopy(ref), IMG)
    gpu_model = ref.cuda()
    x1 = batches[1]
    t0 = time.perf_counter()
    want = cpu_fn(x1.cpu())
    log(f"[serve] CPU forward bs1 in {time.perf_counter() - t0:.1f} s")
    exact_fn = make_serving_forward(gpu_model, IMG, msda_value_dtype=None, stem_fast=False)
    got = exact_fn(x1)
    err, n_keep = compare_detections(got, want, IMG)
    log(f"[serve] card (f32, TF32 off) vs CPU, bs1: scores max_abs_err={err:.3e} (1e-4); "
        f"labels/boxes equal on {n_keep} tie-robust detections")
    fast = make_serving_forward(gpu_model, IMG)(x1)
    err16 = (fast["scores"].cpu() - want["scores"]).abs().max().item()
    log(f"[serve] card (fast stem and bf16 MSDA value, as served) vs CPU: scores "
        f"max_abs_err={err16:.3e} (1e-2)")
    if err16 > 1e-2:
        raise AssertionError(f"bf16 serving scores differ from the CPU forward: {err16}")
    plain_fast = served_with_plain_stem(torch, gpu_model, x1, fast=True)
    err_pf = (plain_fast["scores"].cpu() - want["scores"]).abs().max().item()
    log(f"[serve] card, plain fast stem + bf16 MSDA value vs CPU: scores "
        f"max_abs_err={err_pf:.3e}")
    # the as-served path against a CPU copy in the same modes (the plain fast
    # stem, a bf16 value map): the bf16 roundings are the same up to values
    # whose f32 input differs in its last bits and so rounds the other way
    same_fn = make_serving_forward(copy.deepcopy(ref).cpu(), IMG,
                                   msda_value_dtype=torch.bfloat16, stem_fast=True)
    err_same, n_same = compare_detections(fast, same_fn(x1.cpu()), IMG, tol=SERVED_SAME_TOL)
    log(f"[serve] card (as served) vs CPU in the same modes: scores max_abs_err="
        f"{err_same:.3e} ({SERVED_SAME_TOL:g}); labels/boxes equal on {n_same} tie-robust "
        f"detections")
    report["cpu_compare"] = {"scores_max_abs_err_f32": err, "robust_detections": n_keep,
                             "scores_max_abs_err_bf16": err16,
                             "scores_max_abs_err_plain_fast_stem": err_pf,
                             "scores_max_abs_err_same_modes": err_same,
                             "robust_detections_same_modes": n_same}

    # ---- serving time, ms/img (host clock around a synchronised request).
    # "default" is what a caller gets from PyTorch: cuDNN convolutions in
    # TF32, matrix products in full f32.
    timing = {}
    for mode, conv_tf32, mm_tf32 in (("tf32_off", False, False), ("default", True, False),
                                     ("tf32_on", True, True)):
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.backends.cuda.matmul.allow_tf32 = mm_tf32
        for bs in (1, 16):
            t = host_ms(lambda: fn(batches[bs]), iters=100 if bs == 1 else 20)
            timing[f"bs{bs}_{mode}"] = t
            ms = t["median"]
            p90 = f", p90 {t['p90']:.3f}" if "p90" in t else ""
            log(f"[serve] {mode} bs{bs}: {ms / bs:.3f} ms/img ({bs * 1e3 / ms:.1f} img/s); "
                f"request median {ms:.3f} ms (p25 {t['p25']:.3f}, p75 {t['p75']:.3f}{p90}; "
                f"n={t['n']})")
    report["serving_ms_per_request"] = timing
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    report["profile_bs1_default"] = profile(torch, lambda: fn(batches[1]),
                                            timing["bs1_default"]["median"], "serving bs1")
    torch.backends.cudnn.allow_tf32 = False
    return launches


def served_with_plain_stem(torch, model, x, fast):
    """The served graph (bf16 MSDA value) with the stem's plain version in
    place of its kernel: what the stem mode alone does to the detections."""
    from custom_d_fine_tpu_torch.ops.postprocess import topk_detections
    from custom_d_fine_tpu_torch.ops.stem import fold_stem_weights, stem_fwd_plain

    fw = fold_stem_weights(model.backbone.stem)
    with torch.inference_mode():
        s = stem_fwd_plain(x, fw, fast=fast).permute(0, 3, 1, 2)
        out = model(s, stem_external=True, msda_value_dtype=torch.bfloat16)
        return topk_detections(out["pred_logits"], out["pred_boxes"], 300, IMG)


def profile(torch, step, wall_ms, what, n=10):
    """Device time by kernel over n calls of `step` (torch.profiler's device
    events), and the device's idle share against `wall_ms`, the same call
    timed without the profiler. An extra reading that does not decide the
    run: "not measured" when the profiler records no device time."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    try:
        spans = device_spans(step, n)
    except RuntimeError as e:
        log(f"[profile] not measured ({e})")
        return "not measured"
    if not spans:
        log("[profile] not measured (the profiler recorded no device events)")
        return "not measured"
    by_name = {}
    for name, _, d in spans:
        t, c = by_name.get(name, (0, 0))
        by_name[name] = (t + d, c + 1)
    busy = busy_ms(spans) / n
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    out = {"wall_ms_per_call_unprofiled": wall_ms, "device_busy_ms_per_call": busy,
           "idle_share": max(0.0, 1 - busy / wall_ms), "kernels_per_call": len(spans) / n,
           "top": [{"kernel": k[:120], "ms": t / 1e6 / n, "calls": c / n}
                   for k, (t, c) in rows[:25]]}
    out["port_kernels"] = {}
    for k, (t, c) in rows:  # the port's own kernels, wherever they rank
        m = PORT_KERNELS.search(k)
        if m:
            r = out["port_kernels"].setdefault(m.group(1), {"ms": 0.0, "calls": 0.0})
            r["ms"] += t / 1e6 / n
            r["calls"] += c / n
    for r in out["port_kernels"].values():
        r["ms_per_launch"] = r["ms"] / r["calls"]
    log(f"[profile] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms/call unprofiled, "
        f"idle share {out['idle_share']:.2f}, {len(spans) / n:.0f} device events/call")
    for r in out["top"][:8]:
        log(f"[profile]   {r['ms']:.4f} ms  x{r['calls']:g}  {r['kernel'][:90]}")
    for k, r in sorted(out["port_kernels"].items()):
        log(f"[profile]   port kernel {k}: {r['ms_per_launch']:.4f} ms per launch, "
            f"x{r['calls']:g} per call ({r['ms']:.4f} ms)")
    return out


# ---------------------------------------------------------------- phase 5
def train_batch(torch, B, img, g, max_gt, n_gt=12, num_classes=80):
    """tools/bench_train.py:70-85: uint8 images, n_gt valid GT boxes of
    max_gt per image (cxcy in [0.2, 0.8], wh in [0.05, 0.3])."""
    return {"images": torch.randint(0, 256, (B, *img, 3), dtype=torch.uint8, generator=g),
            "labels": torch.randint(0, num_classes, (B, max_gt), generator=g),
            "boxes": torch.cat([torch.rand(B, max_gt, 2, generator=g) * 0.6 + 0.2,
                                torch.rand(B, max_gt, 2, generator=g) * 0.25 + 0.05], -1),
            "valid": (torch.arange(max_gt) < n_gt)[None].expand(B, -1).contiguous()}


def compare_train_step(torch, report, cfg):
    """One f32 step (TF32 off, bs2 at 320^2) on the card and on a CPU copy
    from the same weights, batch and denoising draws. Conv kernels x sqrt(6),
    as in the serving comparison, so that query selection does not tie.
    total_loss and each loss term at rtol 1e-4 (atol 1e-6; measured 6.9e-6);
    grad_norm at rtol 1e-3 (measured 1.6e-4) and the update (in units of the step's learning rate) within
    0.05 for all but 2% of the elements and within 2.05 for every one: a
    ReLU input within rounding of zero sends its position's gradient one way
    on one side and the other way on the other, and Adam's first step is
    ~sign(gradient) * lr, so a gradient within noise of zero may flip."""
    from custom_d_fine_tpu_torch.models.dfine import build_model
    from custom_d_fine_tpu_torch.train.train_step import build_training

    ref = build_model(cfg, num_classes=80, seed=1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(math.sqrt(6.0))
    sd = ref.state_dict()
    batch = train_batch(torch, 2, (320, 320), torch.Generator().manual_seed(6), cfg.max_gt)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in ("cuda", "cpu"):
        step, state = build_training(cfg, 80, device=dev, bf16=False, state_dict=sd,
                                     use_ema=False)
        t0 = time.perf_counter()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()},
                        torch.Generator().manual_seed(7))
        lr = state.optimizer.adamw.param_groups[0]["lr"]
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in state.model.state_dict().items()})
        log(f"[train] f32 step bs2 320^2 on {dev} in {time.perf_counter() - t0:.1f} s")
    (mg, pg), (mc, pc) = out["cuda"], out["cpu"]
    for k in mc:
        tol = dict(rtol=1e-3, atol=0.0) if k == "grad_norm" else dict(rtol=1e-4, atol=1e-6)
        if not math.isclose(mg[k], mc[k], rel_tol=tol["rtol"], abs_tol=tol["atol"]):
            raise AssertionError(f"train step {k}: card {mg[k]} vs CPU {mc[k]} ({tol})")
    n_far, n_all, worst = 0, 0, 0.0
    for k, w in sd.items():
        if not w.is_floating_point() or "running" in k:
            continue
        d = ((pg[k] - w).double() - (pc[k] - w).double()).abs() / lr
        n_far += int((d > 0.05).sum())
        n_all += d.numel()
        worst = max(worst, d.max().item())
    if worst > 2.05 or n_far > 0.02 * n_all:
        raise AssertionError(f"train step updates differ: {n_far} of {n_all} elements beyond "
                             f"0.05 lr, largest {worst:.3f} lr")
    log(f"[train] card (f32, TF32 off) vs CPU: total_loss {mg['total_loss']:.6f} vs "
        f"{mc['total_loss']:.6f}, grad_norm {mg['grad_norm']:.6f} vs {mc['grad_norm']:.6f}; "
        f"updates: {n_far} of {n_all} elements beyond 0.05 lr, largest {worst:.3f} lr")
    report["train_cpu_compare"] = {"card": mg, "cpu": mc, "updates_beyond_0.05lr": n_far,
                                   "updates_total": n_all, "update_max_diff_lr": worst}


def phase_training(torch, report, batch_size=16, n_warmup=3, n_steps=10):
    from custom_d_fine_tpu_torch.configs import get_model_config
    from custom_d_fine_tpu_torch.ops.msda import msda_bwd, msda_fwd
    from custom_d_fine_tpu_torch.ops.stem import stem_fwd
    from custom_d_fine_tpu_torch.train.train_step import build_training

    cfg = get_model_config("m")
    B = batch_size
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults; autocast runs in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    step, state = build_training("m", 80, seed=0)
    log(f"[train] build_training('m', 80) on {next(state.model.parameters()).device} "
        f"(bf16 autocast, EMA on) in {time.perf_counter() - t0:.1f} s")
    batch = {k: v.cuda() for k, v in
             train_batch(torch, B, IMG, torch.Generator().manual_seed(5), cfg.max_gt).items()}
    dn = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    for _ in range(n_warmup):
        state, m = step(state, batch, dn)
    torch.cuda.synchronize()
    log(f"[train] {n_warmup} warm-up steps in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts set to 0 just before, read just after
    stem_fwd.launches = msda_fwd.launches = msda_bwd.launches = 0
    times, terms = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, dn)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        terms.append(m)
    launches = {"stem_fwd": stem_fwd.launches, "msda_fwd": msda_fwd.launches,
                "msda_bwd": msda_bwd.launches}
    n_layers = cfg.decoder.num_layers
    want = {"stem_fwd": 0, "msda_fwd": n_layers * n_steps, "msda_bwd": n_layers * n_steps}
    log(f"[train] {n_steps} timed steps: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    values = {k: [float(m[k]) for m in terms] for k in terms[0]}
    bad = [k for k, v in values.items() if not all(math.isfinite(x) for x in v)]
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    ms = statistics.median(times)
    q = statistics.quantiles(times, n=4)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] D-FINE-m 640^2 bs{B} bf16: {ms:.2f} ms/step median (p25 {q[0]:.2f}, p75 "
        f"{q[2]:.2f}; n={n_steps}), {B * 1e3 / ms:.1f} img/s; peak device memory {peak:.2f} GB")
    log(f"[train] last step: total_loss {values['total_loss'][-1]:.4f}, grad_norm "
        f"{values['grad_norm'][-1]:.4f}, {len(values) - 2} loss terms, all finite")
    report["training"] = {"batch": B, "img": list(IMG), "ms_per_step": times,
                          "ms_per_step_median": ms, "img_per_s": B * 1e3 / ms,
                          "peak_mem_gb": peak, "metrics": values, "launches": launches}
    report["profile_train_bs16"] = profile(torch, lambda: step(state, batch, dn), ms,
                                           "training bs16", n=5)
    compare_train_step(torch, report, cfg)
    return launches


# ---------------------------------------------------------------- phase 6
# the JAX Trainer's metrics after an epoch (Validator.compute_metrics, then
# the epoch and its mean training loss; custom_d_fine_tpu/train/trainer.py)
TRAINER_METRIC_KEYS = {"f1", "precision", "recall", "iou", "TPs", "FPs", "FNs", "mAP_50",
                       "mAP_50_95", "epoch", "train_loss"}


def write_yolo_set(root, n_train, n_val, num_classes, seed=0):
    """A synthetic YOLO set: JPEGs of 640x480 and 480x640 (grey ground, a few
    coloured rectangles, mild noise), each rectangle a label row; 1-12
    objects an image; train.csv and val.csv."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    names = []
    for i in range(n_train + n_val):
        h, w = (480, 640) if i % 2 else (640, 480)
        img = np.clip(rng.normal(110, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 13))):
            bw, bh = int(rng.integers(24, w // 3)), int(rng.integers(24, h // 3))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            cls = int(rng.integers(0, num_classes))
            img[y1:y1 + bh, x1:x1 + bw] = rng.integers(0, 256, 3)
            rows.append(f"{cls} {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} "
                        f"{bw / w:.6f} {bh / h:.6f}")
        name = f"im{i:03d}.jpg"
        cv2.imwrite(os.path.join(root, "images", name), img)
        with open(os.path.join(root, "labels", f"im{i:03d}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        names.append(name)
    for split, part in (("train", names[:n_train]), ("val", names[n_train:])):
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("\n".join(part) + "\n")


def phase_trainer(torch, report, overrides=()):
    """The port's Trainer for one epoch of D-FINE-m at full width and depth
    (bf16, EMA on, mosaic, multiscale, 4 loader threads) in a process group
    of world size 1 on NCCL, with its eval on the EMA and its checkpoints;
    then a second Trainer that loads `last`. Counts set to 0 just before
    train() and read just after. `overrides` (k=v) go last, for a rehearsal
    at a smaller size."""
    import shutil
    import socket
    import tempfile

    from custom_d_fine_tpu_torch.eval import cocomatch_native
    from custom_d_fine_tpu_torch.ops.msda import msda_bwd, msda_fwd
    from custom_d_fine_tpu_torch.ops.stem import stem_fwd
    from custom_d_fine_tpu_torch.parallel import dist
    from custom_d_fine_tpu_torch.train.trainer import Trainer
    from custom_d_fine_tpu_torch.utils.config import load_config

    num_classes, n_train, n_val = 80, 64, 16
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "data")
        write_yolo_set(data, n_train, n_val, num_classes)
        log(f"[trainer] synthetic YOLO set: {n_train} train + {n_val} val JPEGs (640x480 and "
            f"480x640, 1-12 boxes) in {time.perf_counter() - t0:.1f} s")
        cfg = load_config(overrides=[
            "model_name=m", f"train.data_path={data}", f"train.path_to_save={tmp}/run",
            "train.epochs=1", "train.batch_size=16", "train.num_workers=4",
            f"train.img_size=[{IMG[0]},{IMG[1]}]", "train.dtype=bfloat16", "train.use_ema=true",
            "train.mosaic_augs.mosaic_prob=0.8", "train.mosaic_augs.no_mosaic_epochs=0",
            "train.augs.multiscale_prob=0.5", "exp_name=chip_smoke", *overrides])
        cfg["train"]["label_to_name"] = {i: f"class_{i}" for i in range(num_classes)}
        device, batch_size, img = (cfg["train"][k] for k in ("device", "batch_size", "img_size"))
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0")
        world = dist.init_from_env(device)
        backend = torch.distributed.get_backend()
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        log(f"[trainer] Trainer('{cfg['model_name']}', {img[0]}x{img[1]}, bs{batch_size}, "
            f"{cfg['train']['dtype']}, EMA) on "
            f"{trainer.device}, process group {backend} of world size {world[0]}, in "
            f"{time.perf_counter() - t0:.1f} s")

        steps, step_fn = [], trainer.train_step  # each step's canvas and host time

        def timed_step(state, batch, generator):
            t1 = time.perf_counter()
            out = step_fn(state, batch, generator)
            steps.append((tuple(batch["images"].shape[1:3]), (time.perf_counter() - t1) * 1e3))
            return out

        trainer.train_step = timed_step

        # ---- the main path: counts set to 0 just before, read just after
        stem_fwd.launches = msda_fwd.launches = msda_bwd.launches = 0
        t0 = time.perf_counter()
        history = trainer.train()
        wall = time.perf_counter() - t0
        launches = {"stem_fwd": stem_fwd.launches, "msda_fwd": msda_fwd.launches,
                    "msda_bwd": msda_bwd.launches}
        t = trainer.timings[0]
        n_eval = -(-n_val // batch_size)
        n_layers = trainer.model_cfg.decoder.num_layers
        want = {"stem_fwd": 0, "msda_fwd": n_layers * (t["steps"] + n_eval),
                "msda_bwd": n_layers * t["steps"]}
        log(f"[trainer] 1 epoch: {t['steps']} steps + {n_eval} eval batches: launches "
            f"{launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"expected launches {want}, got {launches}")
        m = history[0]
        if set(m) != TRAINER_METRIC_KEYS:
            raise AssertionError(f"metrics keys {sorted(m)} are not the JAX Trainer's "
                                 f"{sorted(TRAINER_METRIC_KEYS)}")
        params = list(trainer.state.model.parameters())
        finite = bool(torch.stack([p.detach().float().abs().max() for p in params]).isfinite()
                      .all())
        if not (math.isfinite(m["train_loss"]) and finite):
            raise AssertionError(f"non-finite training: loss {m['train_loss']}, params "
                                 f"finite {finite}")
        bare = report.get("training", {}).get("img_per_s")
        img_s = t["images"] / t["train_s"]
        native = cocomatch_native.available()
        log(f"[trainer] epoch wall {t['epoch_s']:.2f} s (train() {wall:.2f} s): training "
            f"{t['train_s']:.2f} s for {t['images']} images = {img_s:.1f} img/s in the "
            f"Trainer" + (f" (bare step, phase 5: {bare:.1f} img/s)" if bare else "")
            + f"; waiting on the loader {t['loader_wait_s']:.2f} s = "
            f"{t['loader_wait_s'] / t['epoch_s']:.3f} of the epoch; eval "
            f"{t['eval_s']:.2f} s; checkpoints {t['checkpoint_s']:.2f} s")
        log("[trainer] steps (canvas, host ms of the step call; the step waits for the "
            "card at the matcher's copy): " + ", ".join(f"{h}x{w} {ms:.1f}"
                                                     for (h, w), ms in steps))
        log(f"[trainer] metrics: train_loss {m['train_loss']:.4f}, f1 {m['f1']:.4f}, mAP_50 "
            f"{m['mAP_50']:.4f}; mAP matched by the "
            f"{'native C++ cocomatch' if native else 'numpy matcher (native build failed)'}")

        # ---- resume: a second Trainer loads `last`
        t0 = time.perf_counter()
        again = Trainer(cfg)
        again.load_checkpoint("last")
        resume_s = time.perf_counter() - t0
        a, b = trainer.state, again.state
        same = all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                   b.model.state_dict().values()))
        same &= all(torch.equal(a.ema[k], b.ema[k]) for k in a.ema)
        sa, sb = a.optimizer.adamw.state_dict(), b.optimizer.adamw.state_dict()
        same &= sa["state"].keys() == sb["state"].keys() and all(
            torch.equal(sa["state"][i][k], sb["state"][i][k])
            for i in sa["state"] for k in ("exp_avg", "exp_avg_sq", "step"))
        same &= ((a.optimizer.count, a.optimizer.mini_step, a.step, trainer.epoch)
                 == (b.optimizer.count, b.optimizer.mini_step, b.step, again.epoch))
        if not same:
            raise AssertionError("the Trainer resumed from `last` differs from the saved one")
        log(f"[trainer] resume: a second Trainer loaded `last` in {resume_s:.2f} s; model, "
            f"EMA, AdamW state, count {b.optimizer.count} and step {b.step} equal the saved "
            f"ones exactly")
        report["trainer"] = {"timings": t, "train_wall_s": wall, "img_per_s": img_s,
                             "steps_canvas_host_ms": steps,
                             "bare_step_img_per_s": bare, "metrics": m,
                             "launches": launches, "cocomatch_native": native,
                             "resume_s": resume_s, "process_group": [backend, world[0]]}
        return launches
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checks-only", action="store_true",
                    help="stop after the kernel checks (no serving or training phase)")
    ap.add_argument("--verbose-build", action="store_true", help="nvcc -Xptxas -v")
    ap.add_argument("--report", metavar="PATH", help="write every reading to this JSON file")
    args = ap.parse_args()
    report = {}
    try:
        import torch

        card = phase_device(report)
        sys.path.insert(0, ROOT)
        phase_build(report, args.verbose_build)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = [check_stem(torch, report), check_msda(torch, report),
                check_msda_bwd(torch, report)]
        paths = {}
        if not args.checks_only:
            paths["serving"] = phase_serving(torch, report)
            paths["training"] = phase_training(torch, report)
            paths["trainer"] = phase_trainer(torch, report)
        for row in rows:  # each path's launches, from its own zeroed counters
            by_path = {p: c[row["name"]] for p, c in paths.items() if c.get(row["name"])}
            row["launches"] = sum(by_path.values()) if paths else None
            row["launches_by_path"] = by_path
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    report["kernels"] = rows
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
