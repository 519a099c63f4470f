"""Host ms per farm step that the farm call spends outside its overflow
read: the span `farm.call` less `farm.overflow_read`, over the farm steps of
benchmark/spans.py's host window (tracing on, no profiler)."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "farm.dispatch_ms")
