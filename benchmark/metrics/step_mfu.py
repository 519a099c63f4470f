"""The whole farm step's share of the card's FP32 peak, in percent: the
operations counted from sizes (benchmark/counts.py: both force evaluations
of every replica, the direct-space pairs and PME) per second of the
measured window, over 67 TFLOP/s."""
from benchmark import counts as c


def read(ctx):
    ops = c.farm_step_ops(ctx.replicas, ctx.pairs, ctx.charged, ctx.grid)
    seconds_per_step = ctx.window_wall / ctx.window_steps
    return 100.0 * ops / seconds_per_step / c.PEAK_FP32
