"""The share of the device's idle time in the traced window's training steps
that falls inside `train.backward` (zero_grad and autograd's backward), %:
benchmark/spans.py lays the program's spans over the profiler's device
intervals, and each idle instant goes to the innermost phase span open at
it. Nothing when the program recorded no spans in the window."""

from benchmark.spans import idle_shares, program_spans


def read(data):
    shares = idle_shares(data.get("profile"), program_spans())
    return shares["backward"] if shares else None
