"""Device ms per farm step owned by the span `k2.rebuild`: K2's rebuild
(ops/direct_force.py::make_rebuild_fn: the cell binning and slot tables of
every replica, one vmapped call), inside the span `direct.rebuild`. The
union of the device intervals launched while it was the innermost span
open, over the farm steps of benchmark/spans.py's profiled window. None
where K2 did not run (no such span)."""
from benchmark import spans


def read(ctx):
    r = spans.readings(ctx)
    if r is None:
        return None
    ns = r["device"]["device_ns"].get("k2.rebuild")
    return None if ns is None else ns * 1e-6 / r["device"]["steps"]
