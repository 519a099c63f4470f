"""Device ms of one batched neighbour rebuild (all replicas) on the
window's end state, as the farm runs it before every farm step (K2's cell
binning or the cluster list): the union of the device intervals of the
chunk's own call, over 10 calls under a CUDA-only profile, the host's
dispatch gaps left out."""
from benchmark import trace


def read(ctx):
    ch = ctx.farm._chunks[0]
    b = ch.b
    xv = b.place(ch.x)
    return trace.device_ms(lambda: b.rebuild(xv, ch.box), 10)
