"""Device ms per farm step in PME: the union of the device intervals
launched inside the spans `pme` (Pme3.batched's energy) and `pme.backward`
(its gradient, on autograd's thread), over the farm steps of
benchmark/spans.py's profiled window."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "pme.device_ms")
