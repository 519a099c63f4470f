"""Device ms per farm step in the constraints (SETTLE and SHAKE on the
positions, RATTLE on the velocities): the union of the device intervals
launched inside the spans `constraints`, over the farm steps of
benchmark/spans.py's profiled window."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "constraints.device_ms")
