"""The program's spans laid over a profiled window's device events.

The port records spans while torch.profiler records
(`custom_d_fine_tpu_torch.utils.profiling.span`), on the profiler's clock:
name, start_ns, end_ns, seq, parent (the enclosing span's seq), step (the
root span's seq) and counts. A step is a root `train.step` span with the
spans that share its step. The readers in `metrics/` take the steps of the
traced window from here:

- the device's idle time inside a step is the step's interval less the
  union of the profile's device intervals;
- each idle instant goes to the innermost phase span open at that instant
  (PHASES; `train.match` lies inside `train.loss`), and what no phase span
  covers is the step's uncovered remainder. The phases' shares and the
  remainder sum to 100 %.

A program that records no spans gives nothing, and the readers return
None."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# phase span -> the share it counts towards
PHASES = {"train.forward": "forward", "train.loss": "loss", "train.match": "match",
          "train.backward": "backward", "train.optimizer": "update", "train.ema": "update"}
SHARES = ("forward", "loss", "match", "backward", "update")

Interval = Tuple[int, int]


def program_spans() -> list:
    """The port's recorded spans; none where the port has no spans."""
    try:
        from custom_d_fine_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def window_steps(profile, spans: Iterable) -> Dict[int, list]:
    """The spans of each step whose `train.step` overlaps the profile's
    events (host and device), by step; the steps of another profiled window
    lie wholly outside them."""
    events = (profile.device + profile.host) if profile is not None else []
    if not events:
        return {}
    lo = min(a for _, a, _ in events)
    hi = max(a + d for _, a, d in events)
    spans = list(spans)
    steps = {s.seq: [] for s in spans if s.name == "train.step" and s.parent is None
             and s.start_ns < hi and s.end_ns > lo}
    for s in spans:
        if s.step in steps:
            steps[s.step].append(s)
    return steps


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same instants."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def subtract(a: Interval, holes: Sequence[Interval]) -> List[Interval]:
    """The instants of `a` outside `holes` (sorted, disjoint)."""
    out, lo = [], a[0]
    for h0, h1 in holes:
        if h1 <= lo:
            continue
        if h0 >= a[1]:
            break
        if h0 > lo:
            out.append((lo, h0))
        lo = max(lo, h1)
    if lo < a[1]:
        out.append((lo, a[1]))
    return out


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the instants in both (each sorted and disjoint)."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _descends(s, ancestor, by_seq) -> bool:
    p = s.parent
    while p is not None:
        if p == ancestor.seq:
            return True
        p = by_seq[p].parent if p in by_seq else None
    return False


def idle_ns(profile, spans: Iterable) -> Optional[Dict[str, int]]:
    """The device's idle ns inside the window's steps, by share (SHARES and
    "uncovered") and in all ("idle"); None without steps."""
    steps = window_steps(profile, spans)
    if not steps:
        return None
    busy = profile.busy_intervals()
    out = dict.fromkeys(SHARES + ("uncovered", "idle"), 0)
    for root, members in steps.items():
        by_seq = {s.seq: s for s in members}
        step = by_seq[root]
        idle = subtract((step.start_ns, step.end_ns), busy)
        phases = [s for s in members if s.name in PHASES]
        for p in phases:
            inner = merge((q.start_ns, q.end_ns) for q in phases if _descends(q, p, by_seq))
            out[PHASES[p.name]] += overlap_ns(idle, subtract((p.start_ns, p.end_ns), inner))
        out["idle"] += sum(b - a for a, b in idle)
    out["uncovered"] = out["idle"] - sum(out[k] for k in SHARES)
    return out


def idle_shares(profile, spans: Iterable) -> Optional[Dict[str, float]]:
    """idle_ns as % of all idle time inside the steps; None without steps
    or idle time."""
    ns = idle_ns(profile, spans)
    if not ns or ns["idle"] <= 0:
        return None
    return {k: 100.0 * ns[k] / ns["idle"] for k in SHARES + ("uncovered",)}


def solve_ms(profile, spans: Iterable) -> Optional[float]:
    """Host ms a step in `train.match.solve`, over the window's steps."""
    steps = window_steps(profile, spans)
    if not steps:
        return None
    ns = sum(s.end_ns - s.start_ns for members in steps.values() for s in members
             if s.name == "train.match.solve")
    return ns / len(steps) / 1e6


def copy_useful(profile, spans: Iterable) -> Optional[float]:
    """% of the matcher's copied cost entries that belong to valid GT
    columns: the sum of `valid_cells` over that of `cells` on the window's
    `train.match.copy` spans."""
    copies = [s for members in window_steps(profile, spans).values() for s in members
              if s.name == "train.match.copy"]
    cells = sum(s.counts.get("cells", 0) for s in copies)
    if not cells:
        return None
    return 100.0 * sum(s.counts.get("valid_cells", 0) for s in copies) / cells
