"""The share of the training steps' criterion loss terms (everything the
criterion computes after the match, one unit of
custom_d_fine_tpu_torch/train/graphs.py) that replayed as CUDA graphs,
%: the sum of `graph_units` over that of `graph_units` + `eager_units` on
the `train.loss` spans of the traced window's steps (benchmark/spans.py).
Nothing when the program counted neither there."""

from benchmark.spans import program_spans, window_steps


def read(data):
    losses = [s for members in window_steps(data.get("profile"), program_spans()).values()
              for s in members if s.name == "train.loss"]
    graphed = sum(s.counts.get("graph_units", 0) for s in losses)
    units = graphed + sum(s.counts.get("eager_units", 0) for s in losses)
    return 100.0 * graphed / units if units else None
