"""benchmark/spans.py: device events put down to the program's spans on
synthetic events (a kernel to the innermost span open on its launching
thread at its launch, else on the main thread; a gap to the main thread's
span at its middle; unions that count overlaps once), the host metrics
read from the spans alone, the readers' silence
where the program has no tracing module, and on the card that a span and
the device trace share one clock."""
import sys
import threading
import types

import pytest

from benchmark import cells, spans
from benchmark.tests.test_bench_layout import ROOT

MAIN, WORKER = 11, 22
METRICS = ("farm.dispatch_ms", "farm.sync_wait_ms", "direct.force_window_ms",
           "direct.rebuild_window_ms", "pme.device_ms", "rest.device_ms",
           "constraints.device_ms")


def _span(name, sid, parent, start, end, tid=MAIN):
    return (name, sid, parent, tid, start, end)


# closed in this order, as the program appends them
SPANS = [
    _span("direct.force", 4, 3, 20, 30),
    _span("pme.backward", 6, 0, 60, 70, WORKER),
    _span("farm.force", 3, 2, 10, 50),
    _span("rest.grad", 5, 2, 55, 80),
    _span("farm.step", 2, 1, 5, 90),
    _span("farm.overflow_read", 7, 1, 92, 98),
    _span("farm.call", 1, 0, 0, 100),
]


def _names(owner):
    return [SPANS[k][0] if k >= 0 else None for k in owner]


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    device = [(c, 200 + c, 201 + c, "k") for c in range(1, 8)]
    launches = {1: (MAIN, 25),        # inside direct.force
                2: (MAIN, 40),        # farm.force, after direct.force
                3: (MAIN, 95),        # the overflow read
                4: (WORKER, 65),      # pme.backward on the worker
                5: (WORKER, 75),      # worker, no span: main's rest.grad
                6: (MAIN, 300)}       # after every span
    owner = spans.attribute(SPANS, device, launches, MAIN)
    assert _names(owner) == ["direct.force", "farm.force",
                             "farm.overflow_read", "pme.backward",
                             "rest.grad", None, None]


def test_a_gap_goes_to_the_span_at_its_middle():
    device = [(1, 10, 20, "k"), (2, 40, 52, "k"), (3, 56, 58, "k"),
              (4, 95, 120, "k")]
    idle = spans.idle_by_span(SPANS, device, MAIN, 0, 100)
    # gaps [0, 10] mid 5 farm.step; [20, 40] mid 30 direct.force's end:
    # farm.force; [52, 56] mid 54 farm.step; [58, 95] mid 76.5 rest.grad
    assert idle == {"farm.step": 10 + 4, "farm.force": 20, "rest.grad": 37}
    assert sum(idle.values()) == 100 - spans.union_ns(
        [(10, 20), (40, 52), (56, 58), (95, 100)])


def test_unions_count_overlaps_once():
    assert spans.union_ns([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    device = [(1, 100, 110, "k"), (2, 105, 120, "k"),      # direct.force
              (3, 130, 140, "k"),                          # pme.backward
              (4, 135, 150, "k"),                          # rest.grad
              (5, 160, 170, "Memcpy HtoD"),                # farm.call
              (6, 90, 95, "k"),                            # no launch
              (7, 300, 310, "k")]           # launched after the window
    launches = {1: (MAIN, 21), 2: (MAIN, 22), 3: (WORKER, 61),
                4: (MAIN, 62), 5: (MAIN, 99), 7: (MAIN, 250)}
    r = spans.summarize(SPANS, device, launches, MAIN)
    assert r["device_ns"]["direct.force"] == 20
    assert r["device_ns"]["pme.backward"] == 10
    assert r["device_ns"]["rest.grad"] == 15
    assert r["busy_ns"] == 20 + 20 + 10 + 5
    assert r["unlaunched"] == 1
    assert r["kernels"] == {"direct.force": 2, "pme.backward": 1,
                            "rest.grad": 1, spans.NONE: 1}
    # outside the farm step's phases: the copy in farm.call, the stray one
    assert r["outside_share"] == pytest.approx(15 / 55)
    v = r["values"]
    assert r["steps"] == 1 and r["wall_ns"] == 100
    assert v["direct.force_window_ms"] == pytest.approx(20e-6)
    assert v["pme.device_ms"] == pytest.approx(10e-6)
    assert v["rest.device_ms"] == pytest.approx(15e-6)
    assert v["constraints.device_ms"] == 0.0
    assert v["direct.rebuild_window_ms"] is None      # no such span


def test_host_readings_come_from_the_spans_alone():
    """farm.dispatch_ms is farm.call less farm.overflow_read, and
    farm.sync_wait_ms the overflow read, per farm step, on the spans of
    a window run without a profiler."""
    later = [(name, sid + 10, parent + 10 if parent else 0, tid,
              start + 100, end + 100)
             for name, sid, parent, tid, start, end in SPANS]
    h = spans.host_readings(SPANS + later)
    assert h["steps"] == 2 and h["wall_ns"] == 200
    assert h["count"]["farm.call"] == h["count"]["farm.overflow_read"] == 2
    assert h["host_ns"]["rest.grad"] == 2 * 25
    v = h["values"]
    assert set(v) == {"farm.dispatch_ms", "farm.sync_wait_ms"}
    assert v["farm.dispatch_ms"] == pytest.approx((100 - 6) * 1e-6)
    assert v["farm.sync_wait_ms"] == pytest.approx(6e-6)


def test_readers_report_nothing_without_the_tracing_module(monkeypatch):
    """The parent of the change that added the spans has no
    molchanica_tpu_torch.tracing: every span metric reads None there."""
    monkeypatch.setitem(sys.modules, "molchanica_tpu_torch.tracing", None)
    ctx = types.SimpleNamespace()
    listed = {m["name"] for m in cells.load_bench(ROOT)["per_layer"]}
    assert set(METRICS) <= listed
    for name in METRICS:
        assert cells.metric_reader(name, ROOT)(ctx) is None
    assert ctx.span_readings is None


@pytest.mark.card
def test_a_span_and_the_device_trace_share_a_clock(card):
    """A span around one large matmul: the runtime call that launched its
    kernel lies inside the span, on the thread the span names, and the
    kernel starts no earlier than the span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from molchanica_tpu_torch import tracing

    a = torch.randn(8192, 8192, device=card)
    (a @ a).sum().item()
    tracing.collect()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with tracing.span("matmul"):
                c = a @ a
            torch.cuda.synchronize()
    finally:
        tracing.disable()
    (s,) = tracing.collect()
    device, launches = spans.parse(prof)
    corr, k0, k1, name = max(device, key=lambda d: d[2] - d[1])
    key, t = launches[corr]
    print(f"span {s}, kernel {name[:60]} [{k0}, {k1}], launch {key} at {t}")
    assert s[4] <= t <= s[5]
    assert k0 >= s[4]
    assert s[3] == threading.get_ident()
    assert key == s[3] & spans.THREAD_BITS
    del c
