"""The device's idle share of a training step, %: 1 - the device's busy
seconds a step (the union of the profiler's device intervals over the traced
window, over its steps) over the seconds a step takes in the untraced window.
The profiler slows the host, so the traced window's own wall time would read
the idle share high. Nothing when the profiler recorded no device event."""


def read(data):
    p, unit = data.get("profile"), data.get("unit_s")
    if p is None or not p.device or not p.units or not unit:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.units / unit)
