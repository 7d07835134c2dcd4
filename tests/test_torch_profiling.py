"""The arithmetic of custom_d_fine_tpu_torch/utils/profiling.py on made-up
device spans (name, start_ns, duration_ns): busy time is the union of the
intervals, and summarize_trace sums device ms by kernel name per call,
heaviest first. The helpers that read the card (device_spans, trace,
events_by_name, StepTimer, device_memory_stats) are held in
tests/test_torch_cuda.py."""

import pytest

from custom_d_fine_tpu_torch.utils.profiling import busy_ms, summarize_trace

SPANS = [("a", 0, 1_000_000), ("b", 500_000, 1_000_000),  # overlap: 1.5 ms busy
         ("a", 3_000_000, 2_000_000),                       # gap, then 2 ms
         ("c", 3_500_000, 500_000)]                         # inside the last one


@pytest.mark.parametrize("spans,want", [(SPANS, 3.5), (SPANS[::-1], 3.5), ([], 0.0),
                                        ([("x", 10, 0)], 0.0)])
def test_busy_ms_is_the_union_of_intervals(spans, want):
    assert busy_ms(spans) == pytest.approx(want)


def test_summarize_trace_by_name_per_call():
    assert summarize_trace(SPANS, n=2) == [("a", 1.5), ("b", 0.5), ("c", 0.25)]
    assert summarize_trace(SPANS, top_k=1) == [("a", 3.0)]
