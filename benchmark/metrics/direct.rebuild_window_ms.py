"""Device ms per batched neighbour rebuild (the M sites placed and the
cluster list or K2's cell grid rebuilt) as the farm step makes it: the union
of the device intervals launched inside the spans `direct.rebuild`, over
their count, in benchmark/spans.py's profiled window."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "direct.rebuild_window_ms")
