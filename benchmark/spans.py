"""The farm's own phases on the card: the program's spans
(molchanica_tpu_torch.tracing) against a CUDA-only profile of the same
window, both on the epoch's clock.

Two windows of CALLS calls of farm.step(dt, k) each, made as the measured
window makes them (each ending in the farm's overflow read), with tracing
on. The first runs without a profiler: the host metrics (`farm.dispatch_ms`,
`farm.sync_wait_ms`) are read from its spans on the host's clock, since
CUPTI's per-launch callbacks slow the host. The second runs under a
CUDA-only profile, whose kineto results are read as they are (no profiler
event tree, as in trace.py): each device event (kernel, copy or fill) is
joined by its correlation id to the runtime call that launched it, and goes
to the innermost span open on the launching thread at that call; where that
thread had none open (autograd's CUDA worker outside `pme.backward`), to
the innermost span open on the main thread then. A group of spans' device
time is the union of its events' intervals, and each idle gap of the
device goes to the innermost span open on the main thread at its middle.

`readings(ctx)` runs the window once per run and caches the readings on
the run's context; the metric readers `benchmark/metrics/<name>.py` take
theirs from it. It returns None (and the readers then report nothing)
where the program has no tracing module. The per-span table and the ten
largest idle shares go to standard error as `[spans]` lines.
"""
from __future__ import annotations

import bisect
import sys
import threading
import time
from collections import Counter, defaultdict

import torch

from . import trace

CALLS = 2
NONE = "(no span)"
# CUPTI gives a runtime call the low 32 bits of its thread's pthread id
THREAD_BITS = 0xFFFFFFFF
# spans whose own kernels are not put down to a phase of the farm step
OUTSIDE = ("farm.call", "farm.step", "farm.overflow_read")


def say(msg):
    print(f"[spans] {msg}", file=sys.stderr, flush=True)


def parse(prof):
    """(device events [(correlation id, start_ns, end_ns, name)], launches
    {correlation id: (thread key, time_ns)}) of a finished profile: the
    runtime calls that launched each device event, with the thread id
    kineto gives them."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], {}
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = int(e.start_ns()), int(e.duration_ns())
        else:
            s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        corr = e.correlation_id()
        if e.device_type() == cuda:
            device.append((corr, s, s + d, e.name()))
        elif corr:
            host[corr] = (e.device_resource_id() & THREAD_BITS, s)
    wanted = {c for c, _, _, _ in device}
    return device, {c: v for c, v in host.items() if c in wanted}


def innermost(spans):
    """{thread id: (times, span indices)}: from each time on, the index in
    `spans` of the innermost span open on that thread (-1: none)."""
    by = defaultdict(list)
    for i, s in enumerate(spans):
        by[s[3] & THREAD_BITS] += [(s[4], 1, -s[5], i), (s[5], 0, 0, i)]
    out = {}
    for tid, marks in by.items():
        marks.sort()
        stack, times, idx = [], [], []
        for t, opens, _, i in marks:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            cur = stack[-1] if stack else -1
            if times and times[-1] == t:
                idx[-1] = cur
            else:
                times.append(t)
                idx.append(cur)
        out[tid] = (times, idx)
    return out


def at(index, t):
    """The span index open at time t in one thread's index (-1: none)."""
    if index is None:
        return -1
    times, idx = index
    k = bisect.bisect_right(times, t) - 1
    return idx[k] if k >= 0 else -1


def attribute(spans, device, launches, main):
    """[span index or -1] per device event: the innermost span open on its
    launching thread at its launch, else the main thread's then."""
    index = innermost(spans)
    out = []
    for corr, _, _, _ in device:
        launch = launches.get(corr)
        if launch is None:
            out.append(-1)
            continue
        key, t = launch
        k = at(index.get(key), t)
        out.append(k if k >= 0 else at(index.get(main & THREAD_BITS), t))
    return out


def union_ns(intervals) -> int:
    return int(sum(e - s for s, e in trace.merge(intervals)))


def idle_by_span(spans, device, main, t0, t1):
    """{span name: ns}: the device's idle time in [t0, t1] (the gaps
    between the union of the device intervals, and before the first and
    after the last), each gap put down to the innermost span open on the
    main thread at its middle."""
    index = innermost(spans).get(main & THREAD_BITS)
    busy = [iv for iv in trace.merge((s, e) for _, s, e, _ in device)
            if iv[1] > t0 and iv[0] < t1]
    edges = [t0] + [v for iv in busy for v in iv] + [t1]
    out = defaultdict(int)
    for a, b in zip(edges[::2], edges[1::2]):
        a, b = max(a, t0), min(b, t1)
        if b > a:
            k = at(index, (a + b) // 2)
            out[spans[k][0] if k >= 0 else NONE] += b - a
    return dict(out)


def ms_per(ns, count):
    return ns * 1e-6 / count if count else None


def host_readings(spans):
    """The readings of a window's spans on the host's clock: per span name
    its count and host ns (inclusive), the farm steps, the window's wall
    (first farm call's start to last one's end) and the host metrics."""
    calls = [s for s in spans if s[0] == "farm.call"]
    n = Counter(s[0] for s in spans)
    host = defaultdict(int)
    for s in spans:
        host[s[0]] += s[5] - s[4]
    steps = n["farm.step"]
    values = {
        "farm.dispatch_ms": ms_per(
            host["farm.call"] - host["farm.overflow_read"], steps),
        "farm.sync_wait_ms": ms_per(host["farm.overflow_read"], steps),
    }
    return dict(values=values, steps=steps, count=dict(n),
                host_ns=dict(host),
                wall_ns=max(s[5] for s in calls) - min(s[4] for s in calls))


def summarize(spans, device, launches, main):
    """The device readings of one profiled window: per span name its
    count and device ns (its own events' union), the farm steps, the
    metric values, the share of device time outside the farm step's
    phases and the idle table. Device events launched outside the window
    (the first and last farm call's ends) are left out."""
    calls = [s for s in spans if s[0] == "farm.call"]
    t0 = min(s[4] for s in calls)
    t1 = max(s[5] for s in calls)
    device = [d for d in device
              if t0 <= launches.get(d[0], (0, d[1]))[1] <= t1]
    owner = attribute(spans, device, launches, main)
    n = Counter(s[0] for s in spans)
    iv = defaultdict(list)
    kernels = Counter()
    for (_, s, e, name), k in zip(device, owner):
        label = spans[k][0] if k >= 0 else NONE
        iv[label].append((s, e))
        if not name.startswith(trace.COPY_PREFIXES):
            kernels[label] += 1
    dev = {name: union_ns(v) for name, v in iv.items()}

    def group_ns(*names):
        return union_ns([x for name in names for x in iv.get(name, ())])

    steps = n["farm.step"]
    total = union_ns([(s, e) for _, s, e, _ in device])
    outside = group_ns(NONE, *OUTSIDE)
    values = {
        "direct.force_window_ms": ms_per(dev.get("direct.force", 0),
                                         n["direct.force"]),
        "direct.rebuild_window_ms": ms_per(dev.get("direct.rebuild", 0),
                                           n["direct.rebuild"]),
        "pme.device_ms": ms_per(group_ns("pme", "pme.backward"), steps),
        "rest.device_ms": ms_per(group_ns("rest.energy", "rest.grad"), steps),
        "constraints.device_ms": ms_per(dev.get("constraints", 0), steps),
    }
    return dict(values=values, steps=steps, count=dict(n),
                device_ns=dev, kernels=dict(kernels),
                wall_ns=t1 - t0, busy_ns=total,
                outside_share=outside / total if total else 0.0,
                unlaunched=sum(1 for c, _, _, _ in device
                               if c not in launches),
                idle=idle_by_span(spans, device, main, t0, t1))


def calls(ctx, n):
    """n farm calls with tracing on; their spans."""
    from molchanica_tpu_torch import tracing

    tracing.collect()
    tracing.enable()
    try:
        for _ in range(n):
            ctx.farm.step(ctx.dt, ctx.k)
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    return tracing.collect()


def window(ctx):
    """(spans, device events, launches) of CALLS farm calls with tracing
    on, under a CUDA-only profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a lead-in call, outside the window: a profile started after
        # others in the process misses some of its first events
        ctx.farm.step(ctx.dt, ctx.k)
        spans = calls(ctx, CALLS)
    device, launches = parse(prof)
    return spans, device, launches


def report(h, r, main, launches, spans):
    """[spans] lines: the host window (h), the profiled window (r), per
    span its host ms (h), own device ms and kernels (r) per farm step, and
    the ten largest idle shares (r)."""
    v = h["values"]
    say(f"host window: {h['steps']} farm steps in "
        f"{h['wall_ns'] * 1e-9:.4f} s; dispatch + sync "
        f"{v['farm.dispatch_ms'] + v['farm.sync_wait_ms']:.3f} ms against "
        f"{h['wall_ns'] * 1e-6 / h['steps']:.3f} ms of wall per farm step")
    steps = r["steps"]
    keys = Counter(k for k, _ in launches.values())
    say(f"profiled window: {steps} farm steps in "
        f"{r['wall_ns'] * 1e-9:.4f} s, device busy "
        f"{r['busy_ns'] * 1e-9:.4f} s; main thread {main}, span threads "
        f"{sorted({s[3] for s in spans})}, launch threads {dict(keys)}; "
        f"device events with no launch {r['unlaunched']}")
    say(f"kernels per farm step {sum(r['kernels'].values()) / steps:.2f}; "
        f"device time outside the farm step's phases "
        f"{100 * r['outside_share']:.3f}%")
    for name in sorted(h["count"], key=lambda k: -h["host_ns"][k]):
        say(f"span {name}: {h['count'][name]} x, host "
            f"{h['host_ns'][name] * 1e-6 / h['steps']:.3f} ms, own device "
            f"{r['device_ns'].get(name, 0) * 1e-6 / steps:.3f} ms, "
            f"{r['kernels'].get(name, 0) / steps:.1f} kernels per farm step")
    if NONE in r["device_ns"]:
        say(f"span {NONE}: own device "
            f"{r['device_ns'][NONE] * 1e-6 / steps:.3f} ms, "
            f"{r['kernels'].get(NONE, 0) / steps:.1f} kernels per farm step")
    for name, ns in sorted(r["idle"].items(), key=lambda kv: -kv[1])[:10]:
        say(f"idle {name}: {ns * 1e-9:.4f} s "
            f"({100 * ns / r['wall_ns']:.2f}% of the profiled window)")


def readings(ctx):
    """The readings of the run's two span windows (made once, cached on
    ctx), or None where the program has no tracing module."""
    if not hasattr(ctx, "span_readings"):
        ctx.span_readings = None
        try:
            import molchanica_tpu_torch.tracing  # noqa: F401
        except ImportError:
            say("the program has no tracing module: no span metrics")
            return None
        t = time.perf_counter()
        torch.cuda.synchronize()
        h = host_readings(calls(ctx, CALLS))
        t_host = time.perf_counter() - t
        spans, device, launches = window(ctx)
        t_step = time.perf_counter() - t - t_host
        main = threading.main_thread().ident
        r = summarize(spans, device, launches, main)
        say(f"host window {t_host:.3f} s; profiled window stepped and "
            f"parsed in {t_step:.3f} s, summarized in "
            f"{time.perf_counter() - t - t_host - t_step:.3f} s")
        report(h, r, main, launches, spans)
        ctx.span_readings = dict(values={**h["values"], **r["values"]},
                                 host=h, device=r)
    return ctx.span_readings


def value(ctx, name):
    r = readings(ctx)
    return None if r is None else r["values"][name]
