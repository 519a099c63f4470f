"""Port parity: MdSim as a user gets it (molchanica_tpu_torch.md.engine with
use_pallas=False: the cluster-pair backend, CSVR, leapfrog, FIRE, `run`
with snapshots, NPT, the finite-difference dH/dlambda, the window backend)
against molchanica_tpu's MdSim with use_pallas=False and
use_scan_chunks=False (its host loop; NPT runs on its scan-chunk path,
the only one with a barostat). The system is tests/test_torch_mdsim.py's:
the solvated 8-residue polyalanine in a 24 A OPC box (1,312 sites), 6 A
cutoff, PME 24^3, a rebuild every 4 steps; both engines start from the
same positions and velocities.

Tolerances (float32 unless named): the force at init within 1e-4 of
max|F| per site plus 1e-5 of the site's direct-space scale
(MdSim.direct_space_scales: excluded solute pairs enter the cluster sums
at up to 1e5 kcal/mol/A and are subtracted again), energy terms rel 1e-5
of |term| plus, for lj and coulomb, the direct space's |e| sums, the
reciprocal term 3e-5; 8 steps of 0.5 fs (velocity-Verlet, leapfrog,
strict Langevin at gamma 0, CSVR fed the reference's own draws) within
5e-3 A; 50 FIRE iterations within 5e-3 A of fire_minimize_hostloop; NPT
run(0.002, 8, 4) in float64, box rel 1e-8 and positions 1e-5 A (in
float32 the scaling virial carries ~50 bar of roundoff from the excluded
pairs in either engine); dH/dlambda at couple 0.5 in float64 rel 1e-6,
in float32 within 4 floors of eps32 (sum|terms| + the direct |e| sums) /
2h, h = 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import BarostatCfg as JBaro
from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md import barostat as JBar
from molchanica_tpu.md.config import MdOverrides as JOv
from molchanica_tpu.md.engine import MdSim as JMd
from molchanica_tpu.md.engine import compute_energy_snapshot as j_snapshot
from molchanica_tpu.md.minimize import fire_minimize_hostloop
from molchanica_tpu.systems import testmols as JTm
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch.md import barostat as TBar
from molchanica_tpu_torch.md import engine as TEng
from molchanica_tpu_torch.md.config import (BarostatCfg, HydrogenConstraint,
                                            Integrator, MdConfig,
                                            MdOverrides)
from molchanica_tpu_torch.md.dynamics import (launch_md,
                                              run_dynamics_blocking)
from molchanica_tpu_torch.md.engine import MdSim, compute_energy_snapshot
from molchanica_tpu_torch.md.minimize import fire_minimize
from molchanica_tpu_torch.ops import clusters as TCl
from molchanica_tpu_torch.systems import testmols as TTm
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)
from jax_reference import reference_scales

torch.set_num_threads(1)

KW = dict(temp_target=310.0, lj_cutoff=6.0, coulomb_cutoff=6.0,
          max_init_relaxation_iters=None, seed=3, neighbor_rebuild_every=4,
          pme_grid=(24, 24, 24))
DT = 0.0005
TERMS = ("bond", "angle", "dihedral", "lj", "coulomb", "recip")
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def system():
    """(system, {dtype: (reference topology, port topology)}, velocities);
    the reference's float64 topology casts every float field."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    jt = asys.topology
    fields = {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS}
    statics = {s: getattr(jt, s) for s in STATIC_FIELDS}
    jt64 = jt.replace(**{f: jnp.asarray(a, jnp.float64)
                         for f, a in fields.items()
                         if np.issubdtype(a.dtype, np.floating)})
    tops = {"float32": (jt, topology_from_numpy(fields, statics)),
            "float64": (jt64, topology_from_numpy(fields, statics,
                                                  dtype=torch.float64))}
    rng = np.random.default_rng(0)
    v0 = rng.normal(size=(jt.n_atoms, 3)) * 2.0 \
        * np.asarray(jt.dof_mask)[:, None]
    return asys, tops, v0


def _pair(system, ji, ti, dtype="float32", chunks=False, top_edit=None,
          **kw):
    """(reference MdSim, port MdSim) on cells_pme without the pallas
    backend, from the same state."""
    asys, tops, v0 = system
    jt, tt = tops[dtype]
    if top_edit is not None:
        jt, tt = top_edit(jt, tt)
    jkw = {k: (JBaro(**dataclasses.asdict(v)) if k == "barostat_cfg"
               else v) for k, v in kw.items()}
    js = JMd(jt, JCfg(integrator=ji, hydrogen_constraint=JH.shake(),
                      use_scan_chunks=chunks, dtype=dtype, **KW, **jkw),
             np.asarray(asys.positions, dtype), box_extent=asys.box_extent,
             velocities=v0.astype(dtype), method="cells_pme", relax=False)
    ts = MdSim(tt, MdConfig(integrator=ti,
                            hydrogen_constraint=HydrogenConstraint.shake(),
                            dtype=dtype, **KW, **kw),
               asys.positions, box_extent=asys.box_extent,
               velocities=v0, method="cells_pme", relax=False, device="cpu")
    assert js._nbr_backend == ts._nbr_backend
    return js, ts


@pytest.fixture(scope="module")
def nve(system):
    return _pair(system, JInt.verlet_velocity(thermostat=None),
                 Integrator.verlet_velocity(thermostat=None))


def _term_ok(k, got, ref, e_scale):
    tol = 3e-5 if k == "recip" else 1e-5
    return abs(got - ref) <= tol * (abs(ref) + e_scale.get(k, 0.0))


def test_force_at_init(nve):
    js, ts = nve
    assert ts._nbr_backend == "clusters"
    assert dataclasses.asdict(ts._plan) == dataclasses.asdict(js._plan)
    s = js.state
    fj, (_, tj) = jax.jit(js.force_fn)(s.positions, s.box, s.couple)
    x = torch.tensor(np.asarray(s.positions))
    ft, (_, tt_) = ts.force_fn(x, ts.state.box, ts.state.couple)
    fj = np.asarray(fj)
    f_scale, e_scale = reference_scales(ts, x)
    err = np.abs(ft.numpy() - fj).max(axis=1)
    tol = 1e-4 * np.abs(fj).max() + 1e-5 * f_scale.numpy()
    assert (err <= tol).all(), float((err / tol).max())
    for k in TERMS:
        assert _term_ok(k, float(tt_[k]), float(tj[k]), e_scale), k
    # the list and order the port rebuilds equal the reference's on the
    # same (placed) positions
    order_j, nbr_j, _ = jax.jit(js._rebuild)(s.positions, s.box)
    order_t, nbr_t, _, _ = ts._rebuild(x, ts.state.box)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))


def test_eight_verlet_steps(nve):
    js, ts = nve
    evals = ts.force_evals
    js.step(DT, 8)
    ts.step(DT, 8)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=5e-3)
    assert ts.step_count == js.step_count == 8
    # n + ceil(n / k) + 1 force evaluations per call
    assert ts.force_evals - evals == 8 + 2 + 1
    m = ts.metrics()
    assert m["steps"] == 8 and abs(m["sim_ps"] - 8 * DT) < 1e-12


@pytest.mark.parametrize("case", ["leapfrog", "langevin_strict_gamma0"])
def test_integrator_steps(system, case):
    if case == "leapfrog":
        ji, ti = JInt.leapfrog(None), Integrator.leapfrog(None)
    else:
        ji = JInt.langevin_middle(gamma=0.0, cadence="strict")
        ti = Integrator.langevin_middle(gamma=0.0, cadence="strict")
    js, ts = _pair(system, ji, ti)
    js.step(DT, 8)
    ts.step(DT, 8)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=5e-3)
    assert abs(ts.temperature() - js.temperature()) \
        <= 0.01 * js.temperature()


def _reference_csvr_draws(key, n_steps, ndof):
    """The (R1, S) that the reference's velocity-Verlet CSVR step draws
    from its key chain over n_steps (md/integrators.py: split per step,
    then split for the normal and the gamma)."""
    @jax.jit
    def draw(key):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        r1 = jax.random.normal(k1, (), jnp.float32)
        s = 2.0 * jax.random.gamma(k2, 0.5 * (ndof - 1.0),
                                   dtype=jnp.float32)
        return key, r1, s

    out = []
    for _ in range(n_steps):
        key, r1, s = draw(key)
        out.append((float(r1), float(s)))
    return out


def test_csvr_with_reference_draws(system, monkeypatch):
    js, ts = _pair(system, JInt.verlet_velocity(0.1),
                   Integrator.verlet_velocity(0.1))
    ndof = jnp.float32(3.0) * jnp.sum(js.top.dof_mask) - js.n_constraints \
        - 3.0
    assert ts._ndof == int(ndof)
    draws = _reference_csvr_draws(js.state.rng_key, 8, ndof)
    fed = list(draws)

    def fake(generator, n, dtype, device):
        assert n == ts._ndof
        r1, s = fed.pop(0)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(s, dtype=dtype, device=device))

    monkeypatch.setattr(TEng, "csvr_draws", fake)
    t0 = ts.temperature()
    js.step(DT, 8)
    ts.step(DT, 8)
    assert not fed
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=5e-3)
    assert abs(ts.temperature() - js.temperature()) \
        <= 0.01 * js.temperature()
    assert ts.temperature() != t0
    # the port's own draws: S has mean ndof - 1, R1 is standard normal
    monkeypatch.undo()
    g = torch.Generator().manual_seed(1)
    s = torch.stack([TEng.csvr_draws(g, 2000, torch.float64, "cpu")[1]
                     for _ in range(200)])
    assert abs(float(s.mean()) - 1999.0) < 5 * (2 * 1999.0 / 200) ** 0.5


def test_fire_relaxation(nve):
    js, ts = nve
    s = js.state
    x0 = np.asarray(s.positions)
    x_j, e_j = fire_minimize_hostloop(
        js.force_fn, jnp.asarray(x0), s.box, s.couple, js.top.dof_mask,
        n_steps=50, constrain_positions=js._cp)
    energies = []
    with torch.no_grad():
        x_t, e_t = fire_minimize(
            ts.force_fn, torch.tensor(x0), ts.state.box, ts.state.couple,
            ts.top.dof_mask, n_steps=50, constrain_positions=ts._cp,
            energies=energies)
    assert len(energies) == 50
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=5e-3)
    _, e_scale = reference_scales(ts, x_t)
    assert abs(float(e_t) - float(e_j)) \
        <= 1e-5 * (abs(float(e_j)) + sum(e_scale.values()))
    assert float(energies[-1]) < float(energies[0])


def test_run_snapshots(system):
    js, ts = _pair(system, JInt.verlet_velocity(thermostat=None),
                   Integrator.verlet_velocity(thermostat=None))
    snaps_j = js.run(DT, 8, 4)
    snaps_t = ts.run(DT, 8, 4)
    assert len(snaps_t) == len(snaps_j) == 2
    assert ts.flush_snapshot_queues() is ts.snapshots
    _, e_scale = reference_scales(ts, ts.state.positions)
    scale = sum(e_scale.values())
    for a, b in zip(snaps_t, snaps_j):
        assert a.time == pytest.approx(b.time, abs=1e-12)
        for f in ("atom_posits", "water_o_posits", "water_h0_posits",
                  "water_h1_posits"):
            ga, gb = getattr(a, f), np.asarray(getattr(b, f))
            assert ga.shape == gb.shape, f
            np.testing.assert_allclose(ga, gb, rtol=0, atol=5e-3)
        for f in ("energy_potential", "energy_potential_nonbonded",
                  "energy_potential_bonded"):
            ra = getattr(b.energy_data, f)
            assert abs(getattr(a.energy_data, f) - ra) \
                <= 1e-5 * (abs(ra) + scale), f
        assert a.kinetic_energy == pytest.approx(b.kinetic_energy,
                                                 rel=1e-2)
        np.testing.assert_array_equal(a.box_extent,
                                      np.asarray(b.box_extent))
        assert a.dhdl == b.dhdl == 0.0


def test_npt_run_float64(system):
    baro = BarostatCfg(pressure_target=1.0, tau=0.1)
    vv = (JInt.verlet_velocity(None), Integrator.verlet_velocity(None))
    js, ts = _pair(system, *vv, dtype="float64", chunks=True,
                   barostat_cfg=baro)
    box0 = float(ts.state.box[0])
    for _ in range(2):
        js.run(0.002, 4, 4)
        ts.run(0.002, 4, 4)
        b_t, b_j = ts.state.box.numpy(), np.asarray(js.state.box)
        np.testing.assert_allclose(b_t, b_j, rtol=1e-8)
        np.testing.assert_allclose(ts.state.positions.numpy(),
                                   np.asarray(js.state.positions), rtol=0,
                                   atol=1e-5)
    assert abs(float(ts.state.box[0]) - box0) > 1e-3   # the box moved
    assert [p[0] for p in ts.pressure_log] == [4, 8]
    assert ts._last_pressure is not None


def _coupled(jt, tt):
    """The whole solute (molecule 0) as the coupled molecule."""
    cm = (np.asarray(jt.mol_id) == 0) * np.asarray(jt.atom_mask)
    return (jt.replace(couple_mask=jnp.asarray(cm, jt.masses.dtype)),
            dataclasses.replace(tt, couple_mask=torch.tensor(
                cm, dtype=tt.masses.dtype)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fd_dhdl(system, dtype):
    vv = (JInt.verlet_velocity(None), Integrator.verlet_velocity(None))
    js, ts = _pair(system, *vv, dtype=dtype, top_edit=_coupled)
    js.configure_alchemical_window(0.5)
    ts.configure_alchemical_window(0.5)
    s = js.state
    d_j = float(jax.jit(js.dhdl_fn)(s.positions, s.box, s.couple))
    st = ts.state
    evals = ts.force_evals
    with torch.no_grad():
        d_t = float(ts.dhdl_fn(st.positions, st.box, st.couple))
    assert ts.force_evals == evals + 2
    if dtype == "float64":
        assert abs(d_t - d_j) <= 1e-6 * abs(d_j)
        return
    _, (_, terms) = ts.force_fn(st.positions, st.box, st.couple)
    _, e_scale = reference_scales(ts, st.positions)
    floor = EPS32 * (sum(abs(float(terms[k])) for k in TERMS)
                     + sum(e_scale.values())) / 2e-3
    assert abs(d_t - d_j) <= 4 * floor, (d_t, d_j, floor)


def test_overflow_replan(system, monkeypatch):
    """A list width too small for the system overflows at the rebuild;
    step() restores the call's first state, replans with M x 1.5 and
    finishes."""
    vv = (JInt.verlet_velocity(None), Integrator.verlet_velocity(None))
    _, ts = _pair(system, *vv)
    plan = ts._plan
    small = dataclasses.replace(plan, m_neighbors=32)
    with monkeypatch.context() as mp:
        mp.setattr(TEng, "plan_clusters", lambda *a, **kw: small)
        ts.rebuild_neighbor_plan()
    assert ts._plan.m_neighbors == 32
    s = ts.state
    assert int(ts._rebuild(s.positions, s.box)[3]) > 0
    with pytest.raises(TEng.ClusterOverflowError):
        with torch.no_grad():
            ts._step_hostloop(DT, 4, False, None)
    ts.state = s
    evals = ts.force_evals
    ts.step(DT, 4)
    assert ts.step_count == 4 and ts._m_scale == 1.5
    assert ts._plan == TCl.plan_clusters(
        np.asarray(system[0].box_extent, np.float32), 6.0,
        ts.top.n_atoms_real, plan.n_atoms, m_scale=1.5)
    assert ts._plan.m_neighbors > plan.m_neighbors
    # one failed attempt (1 + 4 + 1 evaluations) and the replanned one
    assert ts.force_evals - evals == 12
    assert np.isfinite(ts.state.positions.numpy()).all()


def test_window_backend(system):
    vv = (JInt.verlet_velocity(None), Integrator.verlet_velocity(None))
    js, ts = _pair(system, *vv, direct_backend="window")
    assert ts._nbr_backend == "window"
    s = js.state
    fj, (_, tj) = jax.jit(js.force_fn)(s.positions, s.box, s.couple)
    x = torch.tensor(np.asarray(s.positions))
    ft, (_, tt_) = ts.force_fn(x, ts.state.box, ts.state.couple)
    fj = np.asarray(fj)
    # the window evaluates the same pairs as the clusters: their scales
    clus = MdSim(system[1]["float32"][1], ts.cfg.replace(
        direct_backend="auto"), np.asarray(s.positions),
        box_extent=system[0].box_extent, method="cells_pme", relax=False,
        device="cpu")
    f_scale, e_scale = reference_scales(clus, x)
    err = np.abs(ft.numpy() - fj).max(axis=1)
    tol = 1e-4 * np.abs(fj).max() + 1e-5 * f_scale.numpy()
    assert (err <= tol).all(), float((err / tol).max())
    for k in TERMS:
        assert _term_ok(k, float(tt_[k]), float(tj[k]), e_scale), k
    ts.step(DT, 4)
    assert np.isfinite(ts.state.positions.numpy()).all()


def test_default_config_on_the_test_system(system):
    """MdConfig's defaults but a 10-iteration FIRE (200 take ~70 s on one
    CPU core): velocity-Verlet with CSVR at tau 0.1 ps, SHAKE, relaxation,
    the cluster backend (the 1,312 sites would select allpairs_cutoff
    without method="cells_pme")."""
    asys, tops, _ = system
    cfg = MdConfig(max_init_relaxation_iters=10, lj_cutoff=6.0,
                   coulomb_cutoff=6.0)
    assert cfg.integrator.kind == "verlet_velocity"
    assert cfg.integrator.thermostat_tau == 0.1 and not cfg.use_pallas
    sim = MdSim(tops["float32"][1], cfg, asys.positions,
                box_extent=asys.box_extent, method="cells_pme", device="cpu")
    assert sim._nbr_backend == "clusters"
    r = sim.relax_log
    assert r["iters"] == 10 and r["e_last"] < r["e_first"]
    assert r["kept"] == "end" and r["e_end"] <= r["e_first"]
    assert sim.force_evals == 11       # FIRE and its end check
    sim.step(0.001, 4)
    assert np.isfinite(sim.state.positions.numpy()).all()
    assert 0.0 < sim.temperature() < 2000.0


def test_fire_keeps_its_lowest_state(system, monkeypatch):
    """FIRE can climb (on config 3 it ends ~65,000 kcal/mol above its
    start): `best` holds the lowest evaluated state, and MdSim keeps it
    when the end energy fails the reference's check E_end <= E0 +
    max(1% |E0|, 10)."""
    # a force that is not the energy's gradient: FIRE follows the force
    # and the energy first falls, then climbs
    x0 = torch.full((4, 3), 0.45, dtype=torch.float64)

    def force(x, box, couple):
        e = 0.5 * ((x - 0.3) ** 2).sum()
        return 0.1 - x, (e, {})

    energies, best = [], {}
    x, _ = fire_minimize(force, x0, None, None, torch.ones(4),
                         n_steps=200, energies=energies, best=best)
    e = torch.stack(energies)
    i = int(torch.argmin(e))
    assert 0 < i < len(energies) - 1 and float(e[-1]) > float(e[0])
    assert float(best["e"]) == float(e[i])
    assert float(0.5 * ((best["x"] - 0.3) ** 2).sum()) == float(e[i])
    # the engine: a FIRE whose end state fails the check
    asys, tops, v0 = system
    cfg = MdConfig(lj_cutoff=6.0, coulomb_cutoff=6.0, pme_grid=(24, 24, 24),
                   max_init_relaxation_iters=3)
    real = TEng.fire_minimize

    def climbing(force_fn, x0, *a, **kw):
        x, e = real(force_fn, x0, *a, **kw)
        g = torch.Generator().manual_seed(0)
        # every site kicked 0.3 A at random: far uphill
        return x0 + 0.3 * torch.randn(x0.shape, generator=g), e

    monkeypatch.setattr(TEng, "fire_minimize", climbing)
    sim = MdSim(tops["float32"][1], cfg, asys.positions,
                box_extent=asys.box_extent, velocities=v0,
                method="cells_pme", device="cpu")
    r = sim.relax_log
    assert r["kept"] == "lowest" and r["e_end"] > r["e_first"]
    assert r["e_lowest"] <= r["e_first"]
    assert abs(sim.potential_energy() - r["e_lowest"]) \
        <= 1e-5 * abs(r["e_lowest"]) + 1.0


@pytest.mark.parametrize("case,method", [
    ("vacuum", "allpairs"), ("small_box", "allpairs_cutoff"),
    ("cells_pme", "clusters"), ("window", "window")])
def test_select_method(system, case, method):
    asys, tops, v0 = system
    cfg = MdConfig(lj_cutoff=6.0, coulomb_cutoff=6.0,
                   max_init_relaxation_iters=None,
                   direct_backend="window" if case == "window" else "auto")
    kw = dict(box_extent=asys.box_extent, velocities=v0, device="cpu")
    if case == "vacuum":
        kw.update(box_extent=None)
    if case in ("cells_pme", "window"):
        kw.update(method="cells_pme")
    sim = MdSim(tops["float32"][1], cfg, asys.positions, **kw)
    assert (sim._nbr_backend or sim.method) == method


def test_entry_points_need_cuda(system):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    asys, tops, _ = system
    cfg = MdConfig(lj_cutoff=6.0, coulomb_cutoff=6.0)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MdSim(tops["float32"][1], cfg, asys.positions,
                  box_extent=asys.box_extent, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_energy_snapshot(tops["float32"][1], cfg, asys.positions,
                                    asys.box_extent, device=device)


@pytest.mark.parametrize("builder", ["build_ethanol", "build_lj_dimer"])
def test_testmols_match_reference(builder):
    jt, jx = getattr(JTm, builder)()
    tt, tx = getattr(TTm, builder)()
    np.testing.assert_array_equal(tx, np.asarray(jx))
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), f)
    for f in STATIC_FIELDS:
        assert getattr(tt, f) == getattr(jt, f), f


def _ethanol_cfgs(**ov):
    """The verify recipe's configs at gamma 0 (no noise), with `ov`."""
    jcfg = JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                hydrogen_constraint=JH.flexible(), seed=7,
                overrides=JOv(**ov))
    tcfg = MdConfig(integrator=Integrator.langevin_middle(gamma=0.0),
                    hydrogen_constraint=HydrogenConstraint.flexible(),
                    seed=7, overrides=MdOverrides(**ov))
    return jcfg, tcfg


def test_ethanol_vacuum():
    """The verify recipe's system against the reference MdSim: allpairs,
    FIRE over 100 iterations at construction (one block of the
    reference's, which restarts FIRE every 100 iterations; positions
    within 1e-4 A), the force at the relaxed state within 1e-4 of 20
    kcal/mol/A (the size of its bonded terms before FIRE) and the energy
    rel 1e-5, and 20 Langevin steps at gamma 0 within 1e-4 A."""
    jt, jx = JTm.build_ethanol()
    tt, tx = TTm.build_ethanol()
    jcfg, tcfg = _ethanol_cfgs()
    jcfg = jcfg.replace(max_init_relaxation_iters=100)
    tcfg = tcfg.replace(max_init_relaxation_iters=100)
    rng = np.random.default_rng(4)
    v0 = rng.normal(0, 3.0, (9, 3)).astype(np.float32)
    js = JMd(jt, jcfg.replace(use_scan_chunks=False), jx, velocities=v0)
    ts = MdSim(tt, tcfg, tx, velocities=v0, device="cpu")
    assert ts.method == js.method == "allpairs"
    assert ts.relax_log["kept"] == "end"
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=1e-4)
    s = js.state
    fj, (ej, _) = jax.jit(js.force_fn)(s.positions, s.box, s.couple)
    ft, (et, _) = ts.force_fn(torch.tensor(np.asarray(s.positions)), None,
                              ts.state.couple)
    assert np.abs(ft.numpy() - np.asarray(fj)).max() <= 1e-4 * 20.0
    assert abs(float(et) - float(ej)) <= 1e-5 * abs(float(ej))
    js.step(0.001, 20)
    ts.step(0.001, 20)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("ablation", [
    "none", "bonded_disabled", "coulomb_disabled", "lj_disabled",
    "long_range_recip_disabled"])
def test_ethanol_energy_snapshot(ablation):
    """compute_energy_snapshot on ethanol (allpairs) under each ablation:
    every term rel 1e-5 (1e-7 kcal/mol at least) of the reference's, and
    the ablated terms zero."""
    jt, jx = JTm.build_ethanol()
    tt, tx = TTm.build_ethanol()
    ov = {} if ablation == "none" else {ablation: True}
    jcfg, tcfg = _ethanol_cfgs(**ov)
    ref = j_snapshot(jt, jcfg, jx)
    got = compute_energy_snapshot(tt, tcfg, tx, device="cpu")
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert abs(got[k] - r) <= max(1e-5 * abs(r), 1e-7), (k, got[k], r)
    off = {"bonded_disabled": ("bond", "angle", "dihedral"),
           "coulomb_disabled": ("coulomb",), "lj_disabled": ("lj",),
           "long_range_recip_disabled": ("recip",)}.get(ablation, ())
    assert all(got[k] == 0.0 for k in off)


def test_dynamics_entry_points():
    """run_dynamics_blocking and launch_md on ethanol: the snapshots of a
    blocking run, and a background run joined with its snapshots."""
    tt, tx = TTm.build_ethanol()
    _, tcfg = _ethanol_cfgs()
    sim = MdSim(tt, tcfg.replace(max_init_relaxation_iters=None), tx,
                device="cpu")
    snaps = run_dynamics_blocking(sim, 0.001, 20, snapshot_interval=10)
    assert len(snaps) == 2 and snaps[-1].time == pytest.approx(0.02)
    assert snaps[0].water_o_posits is None
    assert snaps[0].atom_posits.shape == (9, 3)
    handle = launch_md(sim, 0.001, 20, snapshot_interval=10)
    out = handle.join(timeout=120)
    assert not handle.running and handle.step_count == 40
    assert len(out) == 4 and np.isfinite(out[-1].energy_data.energy_potential)


def test_instantaneous_pressure_diagnostic():
    rng = np.random.default_rng(6)
    x, v, f = (rng.normal(size=(50, 3)) for _ in range(3))
    box = np.array([20.0, 21.0, 22.0])
    m = rng.uniform(1, 16, 50)
    d = np.ones(50)
    ref = float(JBar.instantaneous_pressure_bar(
        *(jnp.asarray(a) for a in (x, box, v, m, d, f))))
    got = float(TBar.instantaneous_pressure_bar(
        *(torch.tensor(a) for a in (x, box, v, m, d, f))))
    assert got == pytest.approx(ref, rel=1e-12)
