"""Device kernels per farm step, counted in the profiled window (copies and
fills left out): what the farm's host loop launches for all replicas."""
from benchmark import trace


def read(ctx):
    return len(trace.kernels(ctx.events)) / ctx.profile_steps
