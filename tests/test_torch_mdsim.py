"""Port parity: MdSim on its cell-grid path (molchanica_tpu_torch.md.engine
with cfg.use_pallas) and the modules it runs, against molchanica_tpu's
MdSim with its pallas backend on the CPU. The system is the solvated
8-residue polyalanine in a 24 A OPC box (1,312 sites) at a 6 A cutoff with
a 24^3 PME mesh. The reference engine builds its pallas backend with
jax.default_backend patched to report a TPU and its kernel in interpret
mode; both engines start from the same positions and velocities.

Tolerances: constraint projections within 1e-5 A (A/ps); energies rel
1e-5 and autograd forces within 1e-5 of the largest; the whole force at
init within 1e-4 of max|F| per site plus 1e-5 of the site's direct-space
scale (excluded solute pairs enter the kernel at ~1e5 kcal/mol/A and are
subtracted again, which leaves a float32 residue there); 8 velocity-Verlet
steps (no thermostat, dt = 0.5 fs, rebuild every 4) within 5e-3 A.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molchanica_tpu.ops.pallas.direct_force as DF
from molchanica_tpu.md import constraints as JC
from molchanica_tpu.md import energy as JE
from molchanica_tpu.md import state as JST
from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.config import MdOverrides as JOv
from molchanica_tpu.md.engine import MdSim as JMd
from molchanica_tpu.ops import bonded as JB
from molchanica_tpu.ops import nonbonded as JN
from molchanica_tpu.ops import pme as JP
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch.md import constraints as TC
from molchanica_tpu_torch.md import energy as TE
from molchanica_tpu_torch.md import engine as TEng
from molchanica_tpu_torch.md import state as TST
from molchanica_tpu_torch.md.config import (BarostatCfg, HydrogenConstraint,
                                            Integrator, MdConfig,
                                            MdOverrides)
from molchanica_tpu_torch.md.engine import MdSim
from molchanica_tpu_torch.ops import bonded as TB
from molchanica_tpu_torch.ops import direct_force as TDF
from molchanica_tpu_torch.ops import nonbonded as TN
from molchanica_tpu_torch.ops import pme as TP
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)

torch.set_num_threads(1)

KW = dict(temp_target=310.0, lj_cutoff=6.0, coulomb_cutoff=6.0,
          dtype="float32", max_init_relaxation_iters=None, seed=3,
          neighbor_rebuild_every=4, pme_grid=(24, 24, 24), use_pallas=True)
DT = 0.0005


@pytest.fixture(scope="module")
def system():
    """(reference system, port topology, velocities), built once."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    jt = asys.topology
    tt = topology_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS},
        {s: getattr(jt, s) for s in STATIC_FIELDS})
    rng = np.random.default_rng(0)
    v0 = (rng.normal(size=(jt.n_atoms, 3)) * 2.0
          * np.asarray(jt.dof_mask)[:, None]).astype(np.float32)
    return asys, tt, v0


def _tcfg(**kw):
    return MdConfig(integrator=Integrator.verlet_velocity(thermostat=None),
                    hydrogen_constraint=HydrogenConstraint.shake(),
                    **dict(KW, **kw))


def _port(asys, tt, v0, device="cpu", **kw):
    return MdSim(tt, _tcfg(**kw), asys.positions,
                 box_extent=asys.box_extent, velocities=v0,
                 method="cells_pme", relax=False, device=device)


@pytest.fixture(scope="module")
def pair(system):
    asys, tt, v0 = system
    jcfg = JCfg(integrator=JInt.verlet_velocity(thermostat=None),
                hydrogen_constraint=JH.shake(), use_scan_chunks=False, **KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(DF, "make_pallas_direct_fn", functools.partial(
            DF.make_pallas_direct_fn, interpret=True))
        js = JMd(asys.topology, jcfg, asys.positions,
                 box_extent=asys.box_extent, velocities=v0,
                 method="cells_pme", relax=False)
        assert js._nbr_backend == "pallas"
        yield js, _port(asys, tt, v0), asys, tt


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_init_state(pair):
    js, ts, _, _ = pair
    assert ts._plan == TDF.WindowPlan(**vars(js._plan))
    assert ts._recip.grid == (24, 24, 24)
    assert ts.n_constraints == js.n_constraints
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(ts.state.velocities.numpy(),
                                  np.asarray(js.state.velocities))
    assert abs(ts.temperature() - js.temperature()) <= 1e-6 * js.temperature()
    top = ts.top
    t_t = float(TST.instantaneous_temperature(
        ts.state.velocities, top.masses, top.dof_mask, ts.n_constraints))
    t_j = float(JST.instantaneous_temperature(
        js.state.velocities, js.top.masses, js.top.dof_mask,
        js.n_constraints))
    assert abs(t_t - t_j) <= 1e-5 * t_j


@pytest.mark.parametrize("kind", ["shake", "flexible"])
def test_constraint_fns(pair, kind):
    js, _, asys, tt = pair
    box = np.asarray(asys.box_extent, np.float32)
    hc_j = JH.shake() if kind == "shake" else JH.flexible()
    hc_t = HydrogenConstraint.shake() if kind == "shake" else \
        HydrogenConstraint.flexible()
    cp_j, cv_j, n_j = JC.make_constraint_fns(
        js.top, JCfg(hydrogen_constraint=hc_j), _j(box))
    cp_t, cv_t, n_t = TC.make_constraint_fns(
        tt, MdConfig(hydrogen_constraint=hc_t), _t(box))
    assert n_t == n_j == TC.count_constraints(
        tt, MdConfig(hydrogen_constraint=hc_t))
    x = np.asarray(js.state.positions)
    rng = np.random.default_rng(7)
    x_new = (x + rng.normal(0, 0.02, x.shape)).astype(np.float32)
    v = rng.normal(0, 3.0, x.shape).astype(np.float32)
    ref_x = np.asarray(jax.jit(cp_j)(_j(x_new), _j(x)))
    ref_v = np.asarray(jax.jit(cv_j)(_j(v), _j(x)))
    got_x = cp_t(_t(x_new), _t(x)).numpy()
    got_v = cv_t(_t(v), _t(x)).numpy()
    np.testing.assert_allclose(got_x, ref_x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_v, ref_v, rtol=0, atol=1e-5)
    assert np.abs(got_x - x_new).max() > 1e-3     # the projection acted


def _energy_pair(jfn, tfn, x):
    """(E, dE/dx) of a JAX and a torch energy of x -> scalar."""
    e_r, g_r = jax.value_and_grad(jfn)(_j(x))
    xt = _t(x).requires_grad_(True)
    e = tfn(xt)
    g = (torch.autograd.grad(e, xt)[0] if e.requires_grad
         else torch.zeros_like(xt))
    return float(e.detach()), g.numpy(), float(np.float32(e_r)), \
        np.asarray(g_r, np.float32)


@pytest.mark.parametrize("term", ["bonded", "bonded_off", "pair14",
                                  "excl_correction"])
def test_nonbonded_and_bonded_terms(pair, term):
    js, _, asys, tt = pair
    jt = js.top
    box = np.asarray(asys.box_extent, np.float32)
    jb, tb = _j(box), _t(box)
    one_j, one_t = jnp.asarray(1.0, jnp.float32), torch.tensor(1.0)
    x = np.asarray(js.state.positions)
    if term.startswith("bonded"):
        off = term == "bonded_off"
        jfn = lambda xx: JB.bonded_energy(xx, jb, jt, JOv(
            bonded_disabled=off))[0]
        tfn = lambda xx: TB.bonded_energy(xx, tb, tt, MdOverrides(
            bonded_disabled=off))[0]
    elif term == "pair14":
        sj = (1.0 / jt.pair14_scee, 1.0 / jt.pair14_scnb)
        st = (1.0 / tt.pair14_scee, 1.0 / tt.pair14_scnb)
        jfn = lambda xx: sum(JN.pairlist_energy(
            xx, jb, jt, jt.pair14_idx, jt.pair14_mask, *sj, one_j))
        tfn = lambda xx: sum(TN.pairlist_energy(
            xx, tb, tt, tt.pair14_idx, tt.pair14_mask, *st, one_t))
    else:
        jfn = lambda xx: JN.ewald_exclusion_correction(xx, jb, jt, one_j,
                                                       0.52)
        tfn = lambda xx: TN.ewald_exclusion_correction(xx, tb, tt, one_t,
                                                       0.52)
    e, g, e_r, g_r = _energy_pair(jfn, tfn, x)
    if term == "bonded_off":
        assert e == e_r == 0.0 and not g.any()
        return
    assert abs(e - e_r) <= 1e-5 * abs(e_r)
    assert np.abs(g - g_r).max() <= 1e-5 * np.abs(g_r).max()


def test_pme_rest_energy(pair):
    js, ts, asys, tt = pair
    jcfg, tcfg = js.cfg, ts.cfg
    box = np.asarray(asys.box_extent, np.float32)
    jrec = JP.make_pme_recip_fn(js.top, jcfg, box)
    trec = TP.make_pme_recip_fn(tt, tcfg, box, device="cpu")
    assert trec.grid == JP.default_grid(box) == (24, 24, 24)
    je = JE.make_energy_fn(js.top, jcfg, "pme_rest", pme_recip_fn=jrec)
    te = TE.make_energy_fn(tt, tcfg, "pme_rest", pme_recip_fn=trec)
    one_j, one_t = jnp.asarray(1.0, jnp.float32), torch.tensor(1.0)
    x = np.asarray(js.state.positions)
    e, g, e_r, g_r = _energy_pair(
        lambda xx: je(xx, _j(box), one_j)[0],
        lambda xx: te(xx, _t(box), one_t)[0], x)
    assert abs(e - e_r) <= 1e-5 * abs(e_r)
    assert np.abs(g - g_r).max() <= 1e-5 * np.abs(g_r).max()
    _, terms_j = jax.jit(je)(_j(x), _j(box), one_j)
    with torch.no_grad():
        _, terms_t = te(_t(x), _t(box), one_t)
    for k in ("bond", "angle", "dihedral", "lj", "coulomb", "recip"):
        ref = float(np.float32(terms_j[k]))
        assert abs(float(terms_t[k]) - ref) <= 1e-5 * abs(ref), k
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.make_energy_fn(tt, tcfg, "cells_pme", pme_recip_fn=trec)


def _term_ok(k, got, ref, e_scale):
    """rel 1e-5; for lj and coulomb, of |ref| plus the kernel's |e| sums
    (MdSim.direct_space_scales): those totals hold the excluded solute
    pairs (~7e6 kcal/mol of LJ on this system) that the rest energy
    subtracts again, so both terms carry a float32 residue of that size
    times ~1e-7 in the reference and the port alike."""
    return abs(got - ref) <= 1e-5 * (abs(ref) + e_scale.get(k, 0.0))


def test_force_fn_at_init(pair):
    js, ts, _, _ = pair
    s = js.state
    fj, (ej, tj) = jax.jit(js.force_fn)(s.positions, s.box, s.couple)
    x = _t(s.positions)
    ft, (et, tt_) = ts.force_fn(x, ts.state.box, ts.state.couple)
    fj = np.asarray(fj, np.float32)
    err = np.abs(ft.numpy() - fj).max(axis=1)
    f_scale, e_scale = ts.direct_space_scales(x)
    tol = 1e-4 * np.abs(fj).max() + 1e-5 * f_scale.numpy()
    assert (err <= tol).all(), float((err / tol).max())
    assert np.abs(fj).max() > 10.0
    for k in ("bond", "angle", "dihedral", "lj", "coulomb", "recip"):
        assert _term_ok(k, float(tt_[k]), float(np.float32(tj[k])),
                        e_scale), k


def test_potential_energy(pair):
    js, ts, _, _ = pair
    e_ref = float(np.float32(js.potential_energy()))
    e = ts.potential_energy()
    _, e_scale = ts.direct_space_scales(ts.state.positions)
    assert abs(e - e_ref) <= 1e-5 * (abs(e_ref) + sum(e_scale.values()))


def test_eight_verlet_steps(pair):
    """Last in the file: it moves both engines."""
    js, ts, _, _ = pair
    evals = ts.force_evals
    js.step(DT, 8)
    ts.step(DT, 8)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=5e-3)
    assert ts.step_count == js.step_count == 8
    # n + ceil(n / k) + 1 force evaluations (kernel launches) per call
    assert ts.force_evals - evals == 8 + 2 + 1
    assert np.isfinite(ts.state.velocities.numpy()).all()
    m = ts.metrics()
    assert m["steps"] == 8 and abs(m["sim_ps"] - 8 * DT) < 1e-12
    assert np.isfinite(ts.total_energy())


def test_overflow_replan(system, monkeypatch):
    """An undersized plan overflows at the rebuild; step() restores the
    call's first state, replans from it and finishes."""
    asys, tt, v0 = system
    sim = _port(asys, tt, v0)
    plan = sim._plan
    small = TDF.WindowPlan(**dict(vars(plan), capacity=16))
    with monkeypatch.context() as mp:
        mp.setattr(TEng, "plan_window", lambda *a, **kw: small)
        sim.rebuild_neighbor_plan()
    assert sim._plan.capacity == 16
    s = sim.state
    assert int(sim._rebuild(s.positions, s.box)[2]) > 0
    with pytest.raises(TEng.CellOverflowError):
        with torch.no_grad():
            sim._step_hostloop(DT, 4, False, None)
    sim.state = s
    evals = sim.force_evals
    sim.step(DT, 4)
    assert sim.step_count == 4 and sim._plan == plan
    # one failed attempt (4 + 1 + 1 evaluations) and the replanned one
    assert sim.force_evals - evals == 12
    assert np.isfinite(sim.state.positions.numpy()).all()


def test_device_none_needs_cuda(system):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    asys, tt, v0 = system
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _port(asys, tt, v0, device=device)


@pytest.mark.parametrize("case", ["vacuum", "no_pallas", "allpairs_cutoff",
                                  "relax", "barostat", "coupled",
                                  "leapfrog"])
def test_not_ported_raises(system, case):
    asys, tt, v0 = system
    kw = dict(box_extent=asys.box_extent, velocities=v0, method="cells_pme",
              relax=False, device="cpu")
    cfg = _tcfg()
    top = tt
    if case == "vacuum":
        kw.update(box_extent=None, method=None)
    elif case == "no_pallas":
        cfg = _tcfg(use_pallas=False)
    elif case == "allpairs_cutoff":
        kw.update(method=None)           # 1,312 sites: allpairs_cutoff
    elif case == "relax":
        cfg = _tcfg(max_init_relaxation_iters=50)
        kw.update(relax=None)
    elif case == "barostat":
        cfg = _tcfg(barostat_cfg=BarostatCfg())
    elif case == "coupled":
        cm = tt.couple_mask.clone()
        cm[:10] = 1.0
        top = tt.__class__(**{**vars(tt), "couple_mask": cm})
    else:
        cfg = cfg.replace(integrator=Integrator.leapfrog(None))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MdSim(top, cfg, asys.positions, **kw)
