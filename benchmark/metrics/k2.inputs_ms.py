"""Device ms per farm step owned by the span `k2.inputs`: K2's tables
(DirectForce.inputs: the center rows and the ghost array of every
replica), inside the span `direct.force`. The union of the device
intervals launched while it was the innermost span open, over the farm
steps of benchmark/spans.py's profiled window. None where K2 did not run
(no such span)."""
from benchmark import spans


def read(ctx):
    r = spans.readings(ctx)
    if r is None:
        return None
    ns = r["device"]["device_ns"].get("k2.inputs")
    return None if ns is None else ns * 1e-6 / r["device"]["steps"]
