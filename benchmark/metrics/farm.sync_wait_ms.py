"""Host ms per farm step blocked in the farm's overflow read (the span
`farm.overflow_read`, the host's synchronize with the card), over the farm
steps of benchmark/spans.py's host window (tracing on, no profiler)."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "farm.sync_wait_ms")
