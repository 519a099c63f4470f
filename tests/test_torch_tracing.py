"""molchanica_tpu_torch.tracing: spans off and on, their nesting per
thread, the counters, and the replica farm's spans on the 1,312-site
solvated system of tests/test_torch_replicas.py on clusters (made here by
the port's build_solvated_protein, 2 replicas, 2 calls of 2 steps of 0.5
fs): one `direct.rebuild`, two `farm.force` and two `pme` per farm step,
one `farm.overflow_read` per call, and the same positions to the bit with
tracing on and off; on K2 (its plain version), K2's own spans inside the
direct space's and the "k2_rebuild" counter, which clusters never open.
FastSim.run's `md.run` range is held in
tests/test_torch_barostat.py::test_run_trace_dir."""
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.engine import MdSim
from molchanica_tpu_torch.parallel.replicas import ReplicaFarm
from molchanica_tpu_torch.systems.bench_systems import build_solvated_protein

torch.set_num_threads(1)


@pytest.fixture
def on():
    """Tracing on for the test, off and emptied after."""
    tracing.collect()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()


def test_off_records_nothing():
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b
    with a:
        with b:
            pass
    assert tracing.collect() == []


def test_spans_nest(on):
    with tracing.span("outer"):
        with tracing.span("first"):
            pass
        with tracing.span("second"):
            with tracing.span("inner"):
                pass
    spans = {s[0]: s for s in tracing.collect()}
    assert set(spans) == {"outer", "first", "second", "inner"}
    outer = spans["outer"]
    assert outer[2] == 0
    assert spans["first"][2] == spans["second"][2] == outer[1]
    assert spans["inner"][2] == spans["second"][1]
    for name, sid, parent, tid, start, end in spans.values():
        assert tid == threading.get_ident()
        assert start <= end
        if parent:
            p = next(s for s in spans.values() if s[1] == parent)
            assert p[4] <= start and end <= p[5]
    assert spans["first"][5] <= spans["second"][4]


def test_a_thread_starts_its_own_chain(on):
    """A span opened on a second thread has no parent and carries that
    thread's id."""
    seen = {}

    def work():
        seen["tid"] = threading.get_ident()
        with tracing.span("worker"):
            with tracing.span("worker.inner"):
                pass

    with tracing.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = {s[0]: s for s in tracing.collect()}
    assert spans["worker"][2] == 0
    assert spans["worker"][3] == seen["tid"] != threading.get_ident()
    assert spans["worker.inner"][2] == spans["worker"][1]
    assert spans["worker.inner"][3] == seen["tid"]
    assert spans["main"][2] == 0


def test_counters():
    tracing.reset_counters("test.")
    tracing.count("test.a")
    tracing.count("test.a", 2)
    tracing.count("test.b")
    assert tracing.counters("test.") == {"test.a": 3, "test.b": 1}
    tracing.reset_counters("test.a")
    assert tracing.counters("test.") == {"test.b": 1}
    tracing.reset_counters("test.")
    assert tracing.counters("test.") == {}


KW = dict(temp_target=310.0, lj_cutoff=6.0, coulomb_cutoff=6.0,
          max_init_relaxation_iters=None, seed=3, pme_grid=(24, 24, 24))
DT = 0.0005
CALLS, STEPS = 2, 2


@pytest.fixture(scope="module")
def farms():
    """(spans of the traced farm, its positions, the untraced farm's
    positions): two farms of one MdSim on clusters from the same seed,
    CALLS calls of STEPS steps each, one with tracing on."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    dof = np.asarray(asys.topology.dof_mask)
    v0 = np.random.default_rng(0).normal(size=(dof.shape[0], 3)) * 2.0 \
        * dof[:, None]
    sim = MdSim(asys.topology, MdConfig(
        integrator=Integrator.langevin_middle(gamma=1.0),
        hydrogen_constraint=HydrogenConstraint.shake(), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0,
        method="cells_pme", relax=False, device="cpu")
    assert sim._nbr_backend == "clusters"
    out = []
    for traced in (True, False):
        farm = ReplicaFarm(sim, 2, seed=2)
        tracing.collect()
        if traced:
            tracing.enable()
        try:
            for _ in range(CALLS):
                farm.step(DT, STEPS)
        finally:
            tracing.disable()
        out += [tracing.collect(), farm.x.clone()]
    assert out[2] == []
    return out[0], out[1], out[3]


def test_farm_spans(farms):
    spans = farms[0]
    n = Counter(s[0] for s in spans)
    steps = CALLS * STEPS
    assert n["farm.call"] == n["farm.overflow_read"] == CALLS
    assert n["farm.step"] == n["farm.draws"] == n["direct.rebuild"] == steps
    assert n["farm.integrate"] == steps
    for name in ("farm.force", "direct.force", "pme", "pme.backward",
                 "rest.energy", "rest.grad"):
        assert n[name] == 2 * steps, name
    assert n["constraints"] >= steps
    by_id = {s[1]: s for s in spans}

    def parent(s):
        return by_id[s[2]][0] if s[2] else None

    for s in spans:
        if s[0] in ("direct.force", "pme", "rest.energy", "rest.grad"):
            assert parent(s) == "farm.force"
        elif s[0] == "farm.force":
            assert parent(s) in ("farm.step", "farm.integrate")
        elif s[0] == "pme.backward":
            # autograd runs a CPU backward on the calling thread
            assert parent(s) == "rest.grad"
        elif s[0] == "farm.step":
            assert parent(s) == "farm.call"


def test_farm_bitwise_with_tracing(farms):
    _, x_on, x_off = farms
    assert torch.equal(x_on, x_off)


@pytest.fixture(scope="module")
def k2_farm():
    """(spans, "k2_rebuild" count) of a farm of the same system on K2 (its
    plain version on the CPU), CALLS calls of STEPS steps with tracing
    on."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    sim = MdSim(asys.topology, MdConfig(
        integrator=Integrator.langevin_middle(gamma=1.0),
        hydrogen_constraint=HydrogenConstraint.shake(), use_pallas=True,
        **KW), asys.positions, box_extent=asys.box_extent,
        method="cells_pme", relax=False, device="cpu")
    assert sim._nbr_backend == "pallas"
    farm = ReplicaFarm(sim, 2, seed=2)
    tracing.reset_counters("k2_rebuild")
    tracing.collect()
    tracing.enable()
    try:
        for _ in range(CALLS):
            farm.step(DT, STEPS)
    finally:
        tracing.disable()
    return tracing.collect(), tracing.counters("k2_rebuild")


def test_k2_spans_open_inside_the_direct_space(k2_farm):
    """On K2: one `k2.rebuild` inside each `direct.rebuild`, one
    `k2.inputs` and one `k2.kernel` inside each `direct.force`, and the
    counter "k2_rebuild" one per batched rebuild (per farm step, whatever
    the replicas)."""
    spans, counts = k2_farm
    steps = CALLS * STEPS
    n = Counter(s[0] for s in spans)
    assert n["k2.rebuild"] == n["direct.rebuild"] == steps
    assert n["k2.inputs"] == n["k2.kernel"] == n["direct.force"] == 2 * steps
    assert counts == {"k2_rebuild": steps}
    by_id = {s[1]: s for s in spans}
    inside = {"k2.rebuild": "direct.rebuild", "k2.inputs": "direct.force",
              "k2.kernel": "direct.force"}
    for s in spans:
        if s[0] in inside:
            assert by_id[s[2]][0] == inside[s[0]], s


def test_no_k2_spans_on_clusters(farms):
    spans = farms[0]
    assert not [s for s in spans if s[0].startswith("k2.")]
