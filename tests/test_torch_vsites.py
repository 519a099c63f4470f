"""Port parity: FastSim's general virtual-site path
(molchanica_tpu_torch.md.fast_engine: `_apply_vsites` / `_spread_vsite_forces`
through the vp_of / vp_role tables) against molchanica_tpu.md.fast_engine
on the CPU, the reference's Pallas kernels in interpret mode.

No builder of either package produces such a layout (assemble_system
always blocks OPC waters), so the topologies are made by hand from one
OPC box of 150 waters (half water density) in a 21.7 A box at a 5 A
cutoff:
- "jittered": every water's M weight scaled by 1 + 0.01 N(0, 1) from a
  seeded numpy draw, so the layout test fails on the weights, and the
  first vsite row lists its parents as O, H2, H1;
- "reordered": one shared weight and only that reordered row, so the
  layout test fails on the order alone.
Both packages get the same topology arrays, positions and velocities.
The jittered layout is held against the JAX FastSim; the reordered one,
whose M sites and spread forces are those of the untouched box, against
the port's rolled path on that box.

Tolerances are test_torch_fast_engine.py's: the sorted tables exactly
equal, vsite positions within 1e-5 A, the spread of a random force
within 1e-5 of its largest component, the whole force within 1e-4 of
max|F|, and the positions after 4 velocity-Verlet steps within 5e-3 A
(test_torch_barostat.py's trajectory tolerance).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.fast_engine import FastSim as JFast
from molchanica_tpu.molecules.spec import assemble_system
from molchanica_tpu.systems.water import OPC
from molchanica_tpu_torch.md.config import Integrator, MdConfig
from molchanica_tpu_torch.md.fast_engine import FastSim
from test_torch_colpair_range import _port_top

torch.set_num_threads(1)

BOX = 21.7
KW = dict(temp_target=300.0, lj_cutoff=5.0, coulomb_cutoff=5.0,
          dtype="float32", max_init_relaxation_iters=None,
          neighbor_rebuild_every=4, seed=3)
N_STEPS = 4


def _system(layout):
    asys = assemble_system([], box_extent=np.array([BOX] * 3),
                           water_model=OPC, n_waters=150, seed=4)
    jt = asys.topology
    w = np.asarray(jt.vsite_weight, np.float32).copy()
    idx = np.asarray(jt.vsite_idx).copy()
    if layout == "jittered":
        rng = np.random.default_rng(11)
        w = (w * (1.0 + 0.01 * rng.normal(size=w.shape))).astype(np.float32)
    if layout != "blocked":
        idx[0, 2], idx[0, 3] = idx[0, 3], idx[0, 2]
    asys = dataclasses.replace(asys, topology=jt.replace(
        vsite_weight=jnp.asarray(w), vsite_idx=jnp.asarray(idx)))
    rng = np.random.default_rng(0)
    v0 = (rng.normal(size=(jt.n_atoms, 3)) * 2.0
          * np.asarray(jt.dof_mask)[:, None]).astype(np.float32)
    return asys, v0


def _port(layout):
    asys, v0 = _system(layout)
    return FastSim(_port_top(asys), MdConfig(
        integrator=Integrator.verlet_velocity(thermostat=None), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0,
        device="cpu")


@pytest.fixture(scope="module")
def built():
    """(reference, port) FastSim on the jittered layout, and the
    reference's state after construction, before any test steps it: its
    carried force is its jitted force function (want_energy) at that
    state's positions."""
    asys, v0 = _system("jittered")
    js = JFast(asys.topology, JCfg(
        integrator=JInt.verlet_velocity(thermostat=None), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0)
    return js, _port("jittered"), js.state


@pytest.fixture(scope="module")
def pair(built):
    return built[:2]


@pytest.fixture(scope="module")
def initial(built):
    return built[2]


def _st(ts, x):
    return ts.state.replace(x=torch.tensor(np.asarray(x)))


def test_layout_takes_the_general_path(pair):
    js, ts = pair
    assert not js._vsites_rolled and not ts._vsites_rolled
    assert ts._has_vsites
    for f in ("perm", "vsite_idx", "vm_of", "vp_of", "vp_role"):
        np.testing.assert_array_equal(np.asarray(getattr(js.state, f)),
                                      getattr(ts.state, f).numpy(), f)


def test_apply_vsites(pair):
    js, ts = pair
    st = js.state
    ref = np.asarray(js._apply_vsites(st.x, st.vsite_idx, st.box, st.vm_of))
    got = ts._apply_vsites(ts.state.x, ts.state, ts.state.box).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    m = ts.state.vm_of.numpy() < ts._vs_base.shape[0]
    assert m.sum() == 150
    # each M at its own construction from its parents, in float64
    x = got.astype(np.float64)
    idx = np.minimum(ts.state.vsite_idx.numpy(), x.shape[0] - 1)
    box = ts.state.box.numpy().astype(np.float64)
    mi = lambda d: d - box * np.round(d / box)
    w = ts._vs_w.numpy().astype(np.float64)[:, None]
    xm = x[idx[:, 1]] + w * (mi(x[idx[:, 2]] - x[idx[:, 1]])
                             + mi(x[idx[:, 3]] - x[idx[:, 1]]))
    assert np.abs(mi(x[idx[:, 0]] - xm)).max() < 1e-5


def test_spread_vsite_forces(pair):
    js, ts = pair
    st = js.state
    f = np.random.default_rng(5).normal(
        0.0, 50.0, (ts.S, 3)).astype(np.float32)
    ref = np.asarray(js._spread_vsite_forces(
        jnp.asarray(f), st.vsite_idx, st.vp_of, st.vp_role, st.vm_of))
    got = ts._spread_vsite_forces(torch.tensor(f), ts.state).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(f).max())
    # the spread keeps the total force, and the M slots hold none
    m = ts.state.vm_of.numpy() < ts._vs_base.shape[0]
    assert np.abs(got[m]).max() == 0.0
    np.testing.assert_allclose(got.sum(0), f.sum(0), rtol=0, atol=1e-2)


def test_force(pair, initial):
    js, ts = pair
    st = initial
    fj = st.f
    tst = _st(ts, st.x)
    with torch.no_grad():
        ft, _ = ts._make_force_fn(True)(tst.x, tst)
    fj = np.asarray(fj, np.float32)
    assert np.abs(ft.numpy() - fj).max() <= 1e-4 * np.abs(fj).max()
    assert np.abs(fj).max() > 10.0


def test_steps(pair):
    js, ts = pair
    js.step(0.002, N_STEPS)
    ts.step(0.002, N_STEPS)
    xj = js.positions_unsorted()
    xt = ts.positions_unsorted()
    assert np.isfinite(xt).all()
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=5e-3)


def test_reordered_row_against_the_rolled_path():
    """The order of one row alone sends the port down the general path,
    which places the same M sites and spreads the same forces as the
    rolled path on the untouched box (the two paths differ in nothing
    else)."""
    gen, rolled = _port("reordered"), _port("blocked")
    assert not gen._vsites_rolled and rolled._vsites_rolled
    sg, sr = gen.state, rolled.state
    assert torch.equal(sg.perm, sr.perm)
    assert not torch.equal(sg.vp_role, sr.vp_role)
    np.testing.assert_allclose(
        gen._apply_vsites(sg.x, sg, sg.box).numpy(),
        rolled._apply_vsites(sr.x, sr, sr.box).numpy(), rtol=0, atol=1e-5)
    f = torch.tensor(np.random.default_rng(5).normal(
        0.0, 50.0, (gen.S, 3)).astype(np.float32))
    np.testing.assert_allclose(
        gen._spread_vsite_forces(f, sg).numpy(),
        rolled._spread_vsite_forces(f, sr).numpy(), rtol=0,
        atol=1e-5 * float(f.abs().max()))
