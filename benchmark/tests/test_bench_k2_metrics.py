"""The readers of config3_k2.farm13's per-layer metrics on recorded
readings: `k2_roofline` (K2's force kernel and energy sum in the profiled
window's device events) and `k2.rebuild_ms`, `k2.inputs_ms`,
`k2.kernel_ms` (the device ns that benchmark/spans.py put down to the
span of that name, per farm step). Each reads a number where K2 ran and
None where it did not: the cluster backend's cell, or a program without
the k2 spans (the parent of the change that added them)."""
import types

import pytest

from benchmark import cells
from benchmark import counts as c
from benchmark.tests.test_bench_layout import ROOT

SPAN_MS = {"k2.rebuild_ms": "k2.rebuild", "k2.inputs_ms": "k2.inputs",
           "k2.kernel_ms": "k2.kernel"}
STEPS = 4
K2_EVENTS = [("direct_force_kernel", 0.0, 2800.0),      # us
             ("direct_force_energy", 2800.0, 2812.0),
             ("direct_force_kernel", 5000.0, 7800.0),
             ("direct_force_energy", 7800.0, 7812.0)]
CLUSTER_EVENTS = [("cluster_force_kernel", 0.0, 400.0)]


def _ctx(device_ns, events):
    """A run's context with its span readings already made."""
    return types.SimpleNamespace(
        span_readings=dict(values={}, host={}, device=dict(
            device_ns=device_ns, steps=STEPS)),
        events=events, replicas=13, pairs=9.1e6, sites=24940)


def test_the_metrics_are_the_new_cells_alone():
    bench = cells.load_bench(ROOT)
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in ("k2_roofline",) + tuple(SPAN_MS):
        assert listed[name]["workloads"] == ["config3_k2.farm13"]
    got = {m["name"] for m in cells.cell_metrics(bench, "config3_k2.farm13",
                                                 "per_layer")}
    assert got == {"k2_roofline"} | set(SPAN_MS)


@pytest.mark.parametrize("name", sorted(SPAN_MS))
def test_span_readers_read_a_k2_run(name):
    ns = {"k2.rebuild": 8.0e6, "k2.inputs": 4.0e6, "k2.kernel": 2.4e7,
          "direct.force": 1.0e5}
    v = cells.metric_reader(name, ROOT)(_ctx(ns, K2_EVENTS))
    assert v == pytest.approx(ns[SPAN_MS[name]] * 1e-6 / STEPS)


def test_roofline_reads_a_k2_run():
    ctx = _ctx({}, K2_EVENTS)
    v = cells.metric_reader("k2_roofline", ROOT)(ctx)
    bound = c.roofline_ms(13 * c.direct_ops(9.1e6),
                          13 * c.direct_bytes(24940))
    assert v == pytest.approx(100.0 * bound / 2.812)
    assert 0.0 < v < 100.0


@pytest.mark.parametrize("name", sorted(SPAN_MS) + ["k2_roofline"])
def test_silent_where_k2_did_not_run(name):
    read = cells.metric_reader(name, ROOT)
    clusters = {"direct.force": 7.7e5, "direct.rebuild": 4.4e7}
    assert read(_ctx(clusters, CLUSTER_EVENTS)) is None
    if name != "k2_roofline":
        # a program without the tracing module reads no spans at all
        ctx = types.SimpleNamespace(span_readings=None)
        assert read(ctx) is None
