"""The share of the matcher's mask-cost entries that belong to valid GT
rows, %: each `train.match.mask_costs` span's `cells` times the batch's
valid GT rows (`valid_gt_rows` of the `train.match.copy` in the same
`train.match`) over the GT rows that span ran over (`gt_rows`), summed
over the traced window's steps (benchmark/spans.py), over the sum of
`cells`. The mask costs and the copy keep their own counts of rows, so a
copy packed to the valid rows leaves this share as the mask costs make it.
Nothing when the program recorded no such span."""

from benchmark.spans import program_spans, window_steps


def read(data):
    valid = cells = 0
    for members in window_steps(data.get("profile"), program_spans()).values():
        by_seq = {s.seq: s for s in members}
        rows = {s.parent: s.counts.get("valid_gt_rows") for s in members
                if s.name == "train.match.copy"}
        for s in members:
            if s.name != "train.match.mask_costs":
                continue
            costs = by_seq.get(s.parent)
            n = rows.get(costs.parent) if costs else None
            if n is None or not s.counts.get("gt_rows"):
                return None
            cells += s.counts["cells"]
            valid += s.counts["cells"] * n / s.counts["gt_rows"]
    return 100.0 * valid / cells if cells else None
