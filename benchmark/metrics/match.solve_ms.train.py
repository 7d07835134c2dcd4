"""Host ms a training step spends in the matcher's exact solves and GO union
(`train.match.solve`: ops/hungarian.py's host_solve and host_go_union),
over the traced window's steps (benchmark/spans.py). Nothing when the
program recorded no spans in the window."""

from benchmark.spans import program_spans, solve_ms


def read(data):
    return solve_ms(data.get("profile"), program_spans())
