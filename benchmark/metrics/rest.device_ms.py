"""Device ms per farm step in the rest energy (md/energy.py's "pme_rest":
the bonded terms, the Ewald self and exclusion terms, the excluded and 1-4
pairs the direct space added taken out again) and its autograd: the union
of the device intervals launched inside the spans `rest.energy` and
`rest.grad`, PME's backward (`pme.backward`) left out, over the farm steps
of benchmark/spans.py's profiled window."""
from benchmark import spans


def read(ctx):
    return spans.value(ctx, "rest.device_ms")
