"""Percent of the profiled window in which nothing ran on the card:
100 (wall - union of the device intervals) / wall."""
from benchmark import trace


def read(ctx):
    wall = ctx.profile_wall
    return 100.0 * (wall - trace.busy_seconds(ctx.events)) / wall
