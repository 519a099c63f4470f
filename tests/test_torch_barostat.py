"""Port parity of the barostat (molchanica_tpu_torch.md.barostat), FastSim's
NPT periods, its box-drift replan, and FastSim.run with its snapshots,
against molchanica_tpu on the CPU (the reference's Pallas kernels in
interpret mode).

The engine system is test_barostat.py::test_fastsim_npt_water's: 300 OPC
waters in a 24.5 A box, 5.5 A cutoff, Berendsen P = 1 bar, tau = 0.5 ps,
here with velocity-Verlet (no thermostat noise, so both engines stay on
one trajectory), a rebuild every 4 steps, and `run(0.002, 8, 4)`: two
barostat periods with a snapshot after each.

Tolerances: `_mol_com` exactly equal (float64 inputs on a 1/8 grid, whose
sums are exact); `berendsen_mu` and the autograd `scaling_pressure_bar`
to float64 roundoff (rel 1e-12); the finite-difference pressure of the
two engines within 4 of its float32 floor, eps32 * sum|E terms| / 2h over
3V in bar (one rounding of the energy sums, as for dH/dlambda); after
the two periods, box, positions and the rigid O-H distances within 5e-3 A
(float32 roundoff grows along the trajectory), snapshot times and count
exactly, snapshot positions within 5e-3 A and energies within 1e-4 of
the largest energy term.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md import barostat as JB
from molchanica_tpu.md.config import BarostatCfg as JBaro
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.fast_engine import FastSim as JFast
from molchanica_tpu.molecules.spec import assemble_system
from molchanica_tpu.systems.water import OPC
from molchanica_tpu_torch.constants import PRESSURE_KCAL_PER_A3_TO_BAR
from molchanica_tpu_torch.md import barostat as TB
from molchanica_tpu_torch.md.config import BarostatCfg, Integrator, MdConfig
from molchanica_tpu_torch.md.fast_engine import FastSim
from test_torch_colpair_range import _port_top

torch.set_num_threads(1)

BOX = 24.5
DT, N, K = 0.002, 8, 4
KW = dict(temp_target=300.0, lj_cutoff=5.5, coulomb_cutoff=5.5,
          dtype="float32", max_init_relaxation_iters=None,
          neighbor_rebuild_every=K, seed=3)
TERMS = ("bond", "angle", "dihedral", "recip", "lj", "coulomb")
FD_FLOORS = 4.0


def _water_box():
    asys = assemble_system([], box_extent=np.array([BOX] * 3),
                           water_model=OPC, n_waters=300, seed=4)
    rng = np.random.default_rng(0)
    v0 = (rng.normal(size=(asys.topology.n_atoms, 3)) * 2.0
          * np.asarray(asys.topology.dof_mask)[:, None]).astype(np.float32)
    return asys, v0


def _port(asys, v0, **cfg):
    kw = dict(KW, barostat_cfg=BarostatCfg(pressure_target=1.0, tau=0.5))
    kw.update(cfg)
    return FastSim(_port_top(asys), MdConfig(
        integrator=Integrator.verlet_velocity(thermostat=None), **kw),
        asys.positions, box_extent=asys.box_extent, velocities=v0,
        device="cpu")


@pytest.fixture(scope="module")
def npt():
    """(reference, port, system, initial pressures (JAX, port, floor)):
    both engines' FD pressure on the initial state, then run(0.002, 8, 4)
    on each."""
    asys, v0 = _water_box()
    js = JFast(asys.topology, JCfg(
        integrator=JInt.verlet_velocity(thermostat=None),
        barostat_cfg=JBaro(pressure_target=1.0, tau=0.5), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0)
    ts = _port(asys, v0)
    ts.state = ts.state.replace(x=torch.tensor(np.asarray(js.state.x)))
    p_j = float(js._get_baro_fn(DT * K)(js.state)[1])
    evals = ts.force_evals
    with torch.no_grad():
        p_t = float(ts._barostat(ts.state, DT * K)[1])
    assert ts.force_evals == evals + 2
    _, (_, terms) = ts._make_force_fn(True)(ts.state.x, ts.state)
    vol = float(np.prod(np.asarray(js.state.box, np.float64)))
    floor = float(np.finfo(np.float32).eps) * sum(
        abs(float(terms[k])) for k in TERMS) / (2.0 * 2e-3) / (3.0 * vol) \
        * PRESSURE_KCAL_PER_A3_TO_BAR
    js.run(DT, N, snapshot_interval=K)
    ts.evals_before_run = ts.force_evals
    ts.run(DT, N, snapshot_interval=K)
    return js, ts, asys, (p_j, p_t, floor)


def test_mol_com_exact():
    rng = np.random.default_rng(5)
    n, n_mol = 40, 7
    x = rng.integers(-400, 400, (n, 3)) / 8.0
    m = rng.integers(1, 16, n).astype(np.float64)
    dof = (rng.uniform(size=n) > 0.2).astype(np.float64)
    mol = rng.integers(0, n_mol - 1, n)          # molecule n_mol - 1 empty
    ref = JB._mol_com(jnp.asarray(x), jnp.asarray(m), jnp.asarray(dof),
                      jnp.asarray(mol), n_mol)
    got = TB._mol_com(torch.tensor(x), torch.tensor(m), torch.tensor(dof),
                      torch.tensor(mol), n_mol)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got[1][-1]) == 1e-12


@pytest.mark.parametrize("p", [-3000.0, -250.0, 1.0, 480.0, 9000.0])
def test_berendsen_mu(p):
    for tau, dt in ((0.5, 0.04), (0.05, 0.2)):
        ref = float(JB.berendsen_mu(jnp.float64(p), 1.0, tau, dt))
        got = float(TB.berendsen_mu(torch.tensor(p, dtype=torch.float64),
                                    1.0, tau, dt))
        assert got == pytest.approx(ref, rel=1e-12, abs=0.0)


def _lj_system(seed=1, n=48, L=12.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, L, (n, 3)), L


@pytest.mark.parametrize("molecular", [False, True])
def test_scaling_pressure_bar_autograd(molecular):
    """The exact (autograd) scaling pressure, atomic and molecular, on a
    periodic LJ fluid of diatomics, and berendsen_scale_chunk's output."""
    x0, L = _lj_system()
    n = x0.shape[0]
    rng = np.random.default_rng(2)
    v = rng.normal(size=(n, 3))
    m = np.full(n, 39.9)
    dof = np.ones(n)
    mol = np.repeat(np.arange(n // 2), 2) if molecular else None

    def energy(minimum_image, xp):
        def e(x, b, c):
            d = minimum_image(x[:, None, :] - x[None, :, :], b)
            r2 = (d * d).sum(-1) + xp.eye(n) * 1e9
            s6 = (3.4 ** 2 / r2) ** 3
            return (0.5 * 4.0 * 0.24 * (s6 * s6 - s6)).sum()
        return e

    from molchanica_tpu.ops.pbc import minimum_image as jmi
    from molchanica_tpu_torch.ops.pbc import minimum_image as tmi
    kw = {} if mol is None else dict(n_mol=n // 2)
    args_j = [jnp.asarray(a) for a in (x0, [L] * 3, v, m, dof)]
    args_t = [torch.tensor(np.asarray(a, np.float64))
              for a in (x0, [L] * 3, v, m, dof)]
    mj = None if mol is None else jnp.asarray(mol)
    mt = None if mol is None else torch.tensor(mol)
    ref = JB.berendsen_scale_chunk(energy(jmi, jnp), *args_j,
                                   jnp.asarray(1.0), 1.0, 0.5, 0.05,
                                   mol_id=mj, **kw)
    got = TB.berendsen_scale_chunk(energy(tmi, torch), *args_t,
                                   torch.tensor(1.0, dtype=torch.float64),
                                   1.0, 0.5, 0.05, mol_id=mt, **kw)
    assert float(got[2]) == pytest.approx(float(ref[2]), rel=1e-12)
    assert abs(float(got[2])) > 10.0
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_fd_pressure_matches(npt):
    """scaling_pressure_bar_fd through each engine's energy force function
    on one state (the barostat's measurement)."""
    p_j, p_t, floor = npt[3]
    assert np.isfinite(p_t) and abs(p_t) > floor
    assert abs(p_t - p_j) <= FD_FLOORS * floor, (p_t, p_j, floor)


def test_npt_box_and_positions(npt):
    js, ts, asys, _ = npt
    assert ts.step_count == js.step_count == N
    box_j = np.asarray(js.state.box, np.float64)
    box_t = ts.state.box.numpy().astype(np.float64)
    assert abs(box_t[0] / BOX - 1.0) > 1e-4        # the barostat acted
    np.testing.assert_allclose(box_t, box_j, rtol=0, atol=5e-3)
    n = asys.topology.n_atoms_real
    d = np.abs(ts.positions_unsorted()[:n] - js.positions_unsorted()[:n])
    assert d.max() < 5e-3
    top = asys.topology
    x = ts.positions_unsorted()
    ws, wc, st = top.water_start, top.water_count, top.water_site_count
    o = x[ws:ws + wc * st:st]
    for k in (1, 2):
        dh = np.linalg.norm(x[ws + k:ws + wc * st:st] - o, axis=1)
        assert np.abs(dh - top.water_r_oh).max() < 5e-3
    assert ts._last_pressure is not None and js._last_pressure is not None


def test_run_snapshots(npt):
    js, ts, asys, _ = npt
    assert len(ts.snapshots) == len(js.snapshots) == N // K
    n = asys.topology.n_atoms_real
    scale = max(abs(float(ts._last_terms[k])) for k in TERMS)
    for a, b in zip(ts.snapshots, js.snapshots):
        assert a.time == pytest.approx(b.time, rel=1e-12)
        assert np.abs(a.atom_posits[:n] - b.atom_posits[:n]).max() < 5e-3
        for k in ("energy_potential", "energy_potential_nonbonded",
                  "energy_potential_bonded"):
            ea, eb = getattr(a.energy_data, k), getattr(b.energy_data, k)
            assert abs(ea - eb) <= 1e-4 * scale, k
    assert [s.time for s in ts.snapshots] == pytest.approx([0.008, 0.016])
    # per period: 4 steps and 2 FD evaluations; one per snapshot
    assert ts.force_evals - ts.evals_before_run == N + 2 * (N // K) + N // K
    assert ts.computation_time() > 0.0


def test_npt_strong_coupling_tracks_reference():
    """Coupled at dt_eff / tau = 0.08 per period (tau 0.1 ps for 4 steps of
    2 fs; the reference's own NPT test couples at 0.02), both engines
    trace the same pressures and box over six periods from the same
    state: each period's pressure within FD_FLOORS of its float32 floor
    plus 1e-3 of the first period's |P| (the two trajectories part at
    float32 roundoff, and the virial follows), the box within 5e-3 A.
    The oscillation that grew at this coupling on config 3 (PERF.md,
    section 6) does not appear here in either engine: |P| never exceeds the
    first period's."""
    asys, v0 = _water_box()
    baro = dict(pressure_target=1.0, tau=0.1)
    js = JFast(asys.topology, JCfg(
        integrator=JInt.verlet_velocity(thermostat=None),
        barostat_cfg=JBaro(**baro), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0)
    ts = _port(asys, v0, barostat_cfg=BarostatCfg(**baro))
    ts.state = ts.state.replace(x=torch.tensor(np.asarray(js.state.x)))
    vol = BOX ** 3
    p_first = None
    for _ in range(6):
        js.step(DT, K)
        ts.step(DT, K)
        p_j, p_t = float(js._last_pressure), float(ts._last_pressure)
        floor = float(np.finfo(np.float32).eps) * sum(
            abs(float(ts._last_terms[k])) for k in TERMS) / (2.0 * 2e-3) \
            / (3.0 * vol) * PRESSURE_KCAL_PER_A3_TO_BAR
        p_first = abs(p_j) if p_first is None else p_first
        assert abs(p_t - p_j) <= FD_FLOORS * floor + 1e-3 * p_first, \
            (p_t, p_j, floor)
        np.testing.assert_allclose(ts.state.box.numpy(),
                                   np.asarray(js.state.box), rtol=0,
                                   atol=5e-3)
        assert abs(p_j) <= p_first and abs(p_t) <= p_first
    assert np.isfinite(ts.positions_unsorted()).all()


def test_box_drift_replans_and_completes():
    """A barostat driven to its mu clip (mu^3 = 1.06 per period) passes 3%
    box drift in the second period: step() replans at the new box and
    completes every requested step."""
    asys, v0 = _water_box()
    sim = _port(asys, v0, barostat_cfg=BarostatCfg(pressure_target=-1e5,
                                                   tau=0.01))
    evals = sim.force_evals
    sim.step(DT, 3 * K)
    mu = 1.06 ** (1.0 / 3.0)
    assert sim.step_count == 3 * K
    assert sim._sim_time_ps == pytest.approx(3 * K * DT)
    np.testing.assert_allclose(sim._box0, BOX * mu ** 2, rtol=1e-5)
    np.testing.assert_allclose(sim.state.box.numpy(), BOX * mu ** 3,
                               rtol=1e-5)
    assert sim.plan.wx > BOX / sim.plan.nx       # the plan moved with it
    # 12 steps, 2 FD evaluations per period, and the replan's init one
    assert sim.force_evals - evals == 3 * K + 2 * 3 + 1
    x = sim.positions_unsorted()
    top = asys.topology
    ws, wc, st = top.water_start, top.water_count, top.water_site_count
    dh = np.linalg.norm(x[ws + 1:ws + wc * st:st] - x[ws:ws + wc * st:st],
                        axis=1)
    assert np.abs(dh - top.water_r_oh).max() < 5e-3


def test_run_trace_dir(tmp_path):
    """cfg.trace_dir: run() writes a torch.profiler Chrome trace there,
    with the run as a range `md.run`."""
    asys, v0 = _water_box()
    sim = _port(asys, v0, barostat_cfg=None, trace_dir=str(tmp_path))
    snaps = sim.run(DT, 2, snapshot_interval=2)
    assert len(snaps) == 1 and snaps[0].time == pytest.approx(2 * DT)
    assert [p.name for p in tmp_path.iterdir()] == ["fastsim_run_2.json"]
    with open(tmp_path / "fastsim_run_2.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "md.run" in names
