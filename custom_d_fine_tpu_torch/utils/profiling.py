"""Profiling on the card (PyTorch): the program's own spans, and the device
events that torch.profiler records.

The reference's perf observability is wall-clock timing plus nvidia-smi
polling (dl/utils.py:130-157). Here:
- `span(name, **counts)`: a named interval of the program's host time, with
  its parent span, the step it belongs to (the sequence number of its root
  span) and counts taken at the same boundary. Spans record only while
  torch.profiler records; each also opens `record_function(name)`, so an
  exported trace (`export_chrome_trace`, TensorBoard) shows it. `spans()`
  returns the recorded ones, oldest first, from a bounded buffer;
  `clear_spans()` empties it. Their clock is the profiler's (`clock_ns`),
  so a span can be laid over the profiler's device events;
- `device_spans` / `busy_ms` / `events_by_name`: the device events (kernels,
  copies, fills) that torch.profiler records, the time the device was busy
  (the union of the events' intervals) and device time by kernel name.

The kernels' launch counters (`ops/stem.py`, `ops/msda.py`) count always
and are not spans.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import torch

MAX_SPANS = 1 << 16  # the buffer keeps the newest spans

# The one gate: spans record only while torch.profiler records.
_profiler_on = torch.autograd._profiler_enabled


def clock_ns() -> int:
    """The spans' clock: Unix-epoch ns, the clock of the profiler's events
    (kineto's start_ns())."""
    return time.time_ns()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    seq: int               # this span's sequence number
    parent: Optional[int]  # the enclosing span's seq; None for a root
    step: int              # the root span's seq: shared by the spans of one step
    counts: Dict[str, int]


_SPANS: Deque[Span] = deque(maxlen=MAX_SPANS)
_SEQ = itertools.count()
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last


def _stack() -> List["_Open"]:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Off:
    """What `span` returns while no profiler records: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts: int) -> None:
        pass


_OFF = _Off()


class _Open:
    __slots__ = ("name", "counts", "seq", "parent", "step", "start_ns", "_annotation")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts, self.seq = name, counts, next(_SEQ)

    def count(self, **counts: int) -> None:
        """Add to this span's counts."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.seq if outer else None
        self.step = outer.step if outer else self.seq
        stack.append(self)
        self.start_ns = clock_ns()
        self._annotation = torch.autograd.profiler.record_function(self.name)
        self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._annotation.__exit__(*exc)
        end = clock_ns()
        _stack().pop()
        _SPANS.append(Span(self.name, self.start_ns, end, self.seq, self.parent, self.step,
                           self.counts))
        return False


def span(name: str, **counts: int):
    """`with span("train.match.copy", bytes=n) as sp: ...; sp.count(cells=m)`.
    Records while torch.profiler records; otherwise returns a shared no-op."""
    if not _profiler_on():
        return _OFF
    return _Open(name, counts)


def spans() -> List[Span]:
    """The recorded spans, in the order they closed."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


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
