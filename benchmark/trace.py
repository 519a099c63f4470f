"""Reading torch.profiler traces of the card: device intervals, their
union, kernels by name, and the host's work during the device's idle gaps.

chip_smoke.py's profile_calls sums kernel times, which is the busy time on
one stream only; here the busy time is the union of the device intervals,
so overlapping work is counted once.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

COPY_PREFIXES = ("Memcpy", "Memset")


def _events(prof):
    """[(name, on the device, start_us, end_us)] of a finished profile, read
    from its kineto results as they are (the profiler's own event tree,
    which costs minutes at some 10^5 events, is not built)."""
    cuda = torch.autograd.DeviceType.CUDA
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None:
        return [(e.name, e.device_type == cuda, float(e.time_range.start),
                 float(e.time_range.end)) for e in prof.events()]
    out = []
    for e in res.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), e.device_type() == cuda, s, s + d))
    return out


def _device_events(prof):
    return [(n, s, e) for n, dev, s, e in _events(prof) if dev]


def merge(intervals):
    """Sorted, disjoint union of [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def profile_device(fn):
    """Run fn() under a CUDA-only profile (no host ops recorded, so the
    host runs as it does untraced): its device events [(name, start_us,
    end_us)] and the wall seconds of the call, ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    return events, wall


def device_ms(fn, n):
    """Device ms per call of fn(): after one warm call, n back-to-back calls
    under a CUDA-only profile, the union of their device intervals over n
    (the host's dispatch gaps between the kernels left out)."""
    fn()

    def calls():
        for _ in range(n):
            fn()

    events, _ = profile_device(calls)
    return busy_seconds(events) * 1e3 / n


def busy_seconds(events) -> float:
    return sum(e - s for s, e in merge((s, e) for _, s, e in events)) * 1e-6


def kernels(events):
    """The device events that are kernels (no copies or fills)."""
    return [ev for ev in events if not ev[0].startswith(COPY_PREFIXES)]


def top_ops(events, n=10):
    """[[name, seconds]] of the n names with the most device time."""
    by = defaultdict(float)
    for name, s, e in events:
        by[name[:160]] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(fn, n=10):
    """Run fn() under a CPU + CUDA profile; [[host op, seconds]]: the device's
    idle gaps summed by the host op running at each gap's middle (the
    innermost one), the n largest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, host = [], []
    for name, on_dev, s, e in _events(prof):
        if on_dev:
            dev.append((s, e))
        else:
            host.append((s, e, name))
    busy = merge(dev)
    host.sort()
    starts = [h[0] for h in host]
    by = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        k = bisect.bisect_right(starts, mid)
        label = "host, no op recorded"
        for s, e, name in reversed(host[max(0, k - 4000):k]):
            if e >= mid:
                label = name[:160]
                break
        by[label] += (s1 - e0) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
