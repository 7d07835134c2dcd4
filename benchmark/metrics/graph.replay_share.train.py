"""The share of the training step's graphed units (the backbone's stem and
stages and the hybrid encoder: custom_d_fine_tpu_torch/train/graphs.py)
that replayed as CUDA graphs, %: the sum of `graph_units` over that of
`graph_units` + `eager_units` on the `train.forward` spans of the traced
window's steps (benchmark/spans.py). Nothing when the program counted no
units there."""

from benchmark.spans import program_spans, window_steps


def read(data):
    forwards = [s for members in window_steps(data.get("profile"), program_spans()).values()
                for s in members if s.name == "train.forward"]
    graphed = sum(s.counts.get("graph_units", 0) for s in forwards)
    units = graphed + sum(s.counts.get("eager_units", 0) for s in forwards)
    return 100.0 * graphed / units if units else None
