"""Device ms of one batched direct-space force evaluation (all replicas) on
the window's end state: the union of the device intervals of the farm
chunk's own call (K2, or the cluster backend), over 10 calls under a
CUDA-only profile, the host's dispatch gaps left out."""
from benchmark import trace


def read(ctx):
    ch = ctx.farm._chunks[0]
    b = ch.b
    xv = b.place(ch.x)
    nbr, _ = b.rebuild(xv, ch.box)
    return trace.device_ms(lambda: b._direct(xv, ch.box, ch.c, nbr, True), 10)
