"""The whole step's share of the card's peak, %: the least seconds that a
training step's FLOPs need, each op at the peak of the precision it runs in
on this path (counted on the reference's first step at the cell's shapes,
runners/train.py:_counted_step; peaks in benchmark/work.py), over the
measured seconds per step of the untraced window."""


def read(data):
    least, unit = data.get("least_s"), data.get("unit_s")
    if not least or not unit:
        return None
    return 100.0 * least / unit
