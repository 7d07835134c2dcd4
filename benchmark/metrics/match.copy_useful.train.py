"""The share of the cost entries that the matcher copies to the host
(`train.match.copy`) that belong to valid GT columns, %: the sum of the
span's `valid_cells` (S x Q x the images' GT counts) over that of its
`cells`, over the traced window's steps (benchmark/spans.py). 100 where the
matcher packs each image's valid GT columns into [S, Q x the batch's GT
count], as the port's does; below it where a matcher copies the padded
[S, B, Q, max_gt] costs. Nothing when the program recorded no spans in the
window."""

from benchmark.spans import copy_useful, program_spans


def read(data):
    return copy_useful(data.get("profile"), program_spans())
