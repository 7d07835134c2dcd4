"""Profiling and device-memory observability on the card (PyTorch),
counterpart of custom_d_fine_tpu/utils/profiling.py.

The reference's perf observability is wall-clock timing plus nvidia-smi
polling (dl/utils.py:130-157). Here:
- `device_spans` / `busy_ms` / `events_by_name`: the device events (kernels,
  copies, fills) that torch.profiler records, the time the device was busy
  (the union of the events' intervals) and device time by kernel name;
- `trace` / `summarize_trace`: run a callable under the profiler and sum its
  device ms by kernel name, heaviest first;
- `device_memory_stats`: per-card memory in use, peak and total
  (torch.cuda.memory_stats / mem_get_info; the nvidia-smi equivalent);
- `StepTimer`: steady-state host time per call, closed by
  torch.cuda.synchronize() (the TPU's fetch-to-sync protocol does not
  apply: a synchronise waits for the card's queue).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


def device_memory_stats() -> List[Dict[str, float]]:
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_mb": s.get("allocated_bytes.all.peak", 0) / 1e6,
            "bytes_limit_mb": total / 1e6,
            "free_mb": free / 1e6,
        })
    return out


def device_spans(fn: Callable, n: int) -> List[Tuple[str, int, int]]:
    """Run fn n times under torch.profiler; its device events (kernels,
    copies, fills) as (name, start_ns, duration_ns). User annotations
    (record_function ranges that the profiler mirrors on the device's
    timeline, such as the optimizer's step) are not device work and are left
    out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def events_by_name(fn: Callable, n: int = 10) -> List[Dict]:
    """The device events of one call of fn, by kernel name: ms and count per
    call, averaged over n calls, heaviest first (an empty list when the
    profiler records none). fn runs once first, unprofiled."""
    fn()
    torch.cuda.synchronize()
    by_name: Dict[str, Tuple[float, int]] = {}
    for name, _, d in device_spans(fn, n):
        t, c = by_name.get(name, (0, 0))
        by_name[name] = (t + d, c + 1)
    return [{"kernel": k[:120], "ms": t / 1e6 / n, "calls": c / n}
            for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])]


def trace(fn: Callable, *args, n: int = 1, top_k: int = 25):
    """Run fn(*args) n times under the profiler; return (the last result,
    summarize_trace of its device events)."""
    result = []

    def call():
        result[:] = [fn(*args)]

    spans = device_spans(call, n)
    return result[0], summarize_trace(spans, top_k=top_k, n=n)


def summarize_trace(spans, top_k: int = 25, n: int = 1) -> List[Tuple[str, float]]:
    """Device ms by kernel name per call (of n), heaviest first."""
    durations: Dict[str, float] = defaultdict(float)
    for name, _, d in spans:
        durations[name] += d / 1e6 / n
    return sorted(durations.items(), key=lambda kv: -kv[1])[:top_k]


class StepTimer:
    """Steady-state host ms per call of fn: n calls dispatched back to back,
    then one torch.cuda.synchronize(), as the JAX package's pipelined
    protocol dispatches n calls and fetches once."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def measure(self, *args, n: int = 100, warmup: int = 5) -> float:
        for _ in range(warmup):
            self.fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            self.fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000 / n
