"""The share of the device's idle time in the traced window's training steps
that falls inside the mask head, its matching costs or its losses, %: the
idle instants of each `train.step` (its interval less the union of the
profiler's device intervals, benchmark/spans.py) inside any
`model.mask_head`, `train.match.mask_costs` or `train.loss.masks` span,
over all idle time inside the steps. Nothing when the program recorded no
mask span in the window (a detect model, or a program without the spans)."""

from benchmark.spans import merge, overlap_ns, program_spans, subtract, window_steps

MASK_SPANS = ("model.mask_head", "train.match.mask_costs", "train.loss.masks")


def read(data):
    profile = data.get("profile")
    steps = window_steps(profile, program_spans())
    busy = profile.busy_intervals() if steps else []
    idle = inside = masked = 0
    for root, members in steps.items():
        (step,) = [s for s in members if s.seq == root]
        gaps = subtract((step.start_ns, step.end_ns), busy)
        spans = merge((s.start_ns, s.end_ns) for s in members if s.name in MASK_SPANS)
        masked += len(spans)
        idle += sum(b - a for a, b in gaps)
        inside += overlap_ns(gaps, spans)
    return 100.0 * inside / idle if masked and idle > 0 else None
