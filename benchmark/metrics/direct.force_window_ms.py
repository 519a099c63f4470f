"""Device ms per batched direct-space force evaluation as the farm step
makes it: the union of the device intervals launched inside the spans
`direct.force`, over their count, in benchmark/spans.py's profiled window."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "direct.force_window_ms")
