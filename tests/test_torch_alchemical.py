"""Port parity of the hydration free-energy path: FastSim's alchemical
force (has_alch colpair kernels, the couple-intramol=no compensation
term), `dhdl`, `minimize` and init relaxation, the TI functions, and the
committed methanol MolSpec, against the JAX package on the CPU (its
Pallas kernels in interpret mode).

The engine system is a 4-atom chain (the 3-atom bent ligand of
tests/test_alchemical_consistency.py plus one bonded atom, so its 1-4
pair 0-3 has no dihedral and is a compensation pair) coupled as molecule
0 in a 24 A OPC box, 6 A cutoff, PME grid 24^3, 1,364 sites.

Tolerances: energy terms rel < 1e-5, the reciprocal term 3e-5 (as in
tests/test_torch_fast_engine.py); forces within 1e-4 of the largest force
plus 2e-6 of the largest direct-space kernel force (float32 cancellation
of excluded pairs). dH/dlambda is a float32 central difference with
h = 1e-3: one float32 rounding of the energy sums costs about
FLOOR = eps32 * sum|terms| / 2h (~3 kcal/mol here), so the two engines
agree within DHDL_FLOORS = 4 of it, and the energies E(couple +- h) are
held term by term. `minimize` moves every site 0.02 A along its force
direction per iteration; after 2 rebuild periods (4 moves) positions
agree within 1e-3 A (5% of one move: a direction can turn by the
force-noise floor over the force at weakly pushed sites) and the returned
energy within 1e-5 of max(|E|, |E_lj|). The TI functions agree exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md import alchemical as JA
from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.fast_engine import FastSim as JFast
from molchanica_tpu.molecules.spec import MolSpec, assemble_system
from molchanica_tpu.ops.nonbonded import intramol_recip_compensation
from molchanica_tpu.systems.water import OPC
from molchanica_tpu_torch.md import alchemical as TA
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.fast_engine import FastSim
from molchanica_tpu_torch.molecules import spec_json
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)

torch.set_num_threads(1)

BOX = 24.0
COUPLE = 0.5
H = 1e-3
DHDL_FLOORS = 4.0
KW = dict(temp_target=310.0, lj_cutoff=6.0, coulomb_cutoff=6.0,
          dtype="float32", max_init_relaxation_iters=None, seed=3,
          neighbor_rebuild_every=2, pme_grid=(24, 24, 24))
TERMS = ("bond", "angle", "dihedral", "recip", "lj", "coulomb")


def _system():
    solute = MolSpec(
        masses=[15.0, 12.0, 15.0, 14.0],
        charges=[-0.5, 0.1, 0.6, -0.2],
        lj_sigma=[3.2, 3.4, 3.2, 3.3],
        lj_eps=[0.2, 0.1, 0.2, 0.15],
        positions=np.array([[0.0, 0.0, 0.0], [1.4, 0.0, 0.0],
                            [2.1, 1.2, 0.0], [3.5, 1.3, 0.2]]) + BOX / 2.0,
        bonds=[(0, 1, 300.0, 1.4), (1, 2, 300.0, 1.4), (2, 3, 300.0, 1.45)],
        angles=[(0, 1, 2, 60.0, 2.0), (1, 2, 3, 60.0, 2.0)])
    asys = assemble_system([solute], box_extent=np.array([BOX] * 3),
                           water_model=OPC, alchemical_mol=0, seed=1)
    rng = np.random.default_rng(0)
    v0 = (rng.normal(size=(asys.topology.n_atoms, 3)) * 2.0
          * np.asarray(asys.topology.dof_mask)[:, None]).astype(np.float32)
    return asys, v0


def _port_top(jt, **fields):
    arrays = {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS}
    arrays.update(fields)
    return topology_from_numpy(arrays,
                               {s: getattr(jt, s) for s in STATIC_FIELDS})


def _port(asys, v0, **cfg):
    return FastSim(_port_top(asys.topology),
                   MdConfig(integrator=Integrator.langevin_middle(gamma=0.0),
                            hydrogen_constraint=HydrogenConstraint.shake(),
                            **{**KW, **cfg}),
                   asys.positions, box_extent=asys.box_extent,
                   velocities=v0, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """(reference FastSim, port FastSim, system) at couple 0.5, from the
    same positions and velocities."""
    asys, v0 = _system()
    js = JFast(asys.topology,
               JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                    hydrogen_constraint=JH.shake(), **KW),
               asys.positions, box_extent=asys.box_extent, velocities=v0)
    ts = _port(asys, v0)
    js.configure_alchemical_window(1.0 - COUPLE)
    ts.configure_alchemical_window(1.0 - COUPLE)
    ts.state = ts.state.replace(x=torch.tensor(np.asarray(js.state.x)))
    return js, ts, asys


def _energies(js, ts, couple):
    """Reference and port (e, terms) of the energy force function on the
    reference's state at `couple` (a float32 value)."""
    force_j = js._make_force_fn(None, want_energy=True)
    st = js.state.replace(couple=jnp.float32(couple))
    _, (ej, tj) = jax.jit(lambda x, s: force_j(x, s))(st.x, st)
    tst = ts.state.replace(couple=torch.tensor(np.float32(couple)))
    with torch.no_grad():
        ft, (et, tt) = ts._make_force_fn(True)(tst.x, tst)
    return (float(ej), tj), (float(et), tt), ft


def _terms_ok(tj, tt):
    for k in TERMS:
        ref = float(np.float32(tj[k]))
        tol = 3e-5 if k == "recip" else 1e-5
        assert abs(float(tt[k]) - ref) <= tol * abs(ref), k


def _floor(tt):
    return float(np.finfo(np.float32).eps) \
        * sum(abs(float(tt[k])) for k in TERMS) / (2.0 * H)


def test_alchemical_engine_setup(pair):
    js, ts, _ = pair
    assert ts._has_alch and js._has_alch
    names = {k.name for kk in ts._split["kernels"].values()
             for k in kk.values()}
    assert names == {"colpair_full_alch_force", "colpair_full_alch_energy",
                     "colpair_coul_wf_alch_force",
                     "colpair_coul_wf_alch_energy"}
    assert all(k.cfg.kpoly is None for kk in ts._split["kernels"].values()
               for k in kk.values())
    np.testing.assert_array_equal(np.asarray(js._im_idx_base),
                                  ts._im_idx_base.numpy())
    ref = np.minimum(np.asarray(js.state.intra_idx), js.S - 1)
    np.testing.assert_array_equal(ref, ts.state.intra_idx.numpy())
    assert float(ts.state.couple) == np.float32(COUPLE)


def test_alchemical_force_and_terms(pair):
    js, ts, asys = pair
    st = js.state
    force_j = js._make_force_fn(None, want_energy=True)
    fj, (_, tj) = jax.jit(lambda x, s: force_j(x, s))(st.x, st)
    tst = ts.state
    with torch.no_grad():
        ft, (_, tt) = ts._make_force_fn(True)(tst.x, tst)
        ft0, _ = ts._make_force_fn(False)(tst.x, tst)
        sp = tst.split
        x_ext = torch.cat([tst.x, torch.full((1, 3), 1e6)])
        rows = torch.cat([x_ext[sp["idx_l"]], sp["props_l"]], 1)
        f_dir, _, _ = ts._split["kernels"][False]["L"](
            rows, rows.T.contiguous(), sp["wl_l"], sp["nw_l"], tst.box,
            tst.couple)
    _terms_ok(tj, tt)
    # the compensation term against the reference's own formula
    comp = float(intramol_recip_compensation(
        jnp.asarray(js.positions_unsorted()), jnp.asarray(asys.box_extent),
        asys.topology, js._im_idx_base, js._im_mask, jnp.float32(COUPLE),
        js.beta))
    assert abs(float(tt["comp"])) > 0.1
    assert abs(float(tt["comp"]) - comp) <= 1e-5 * abs(comp)
    fj = np.asarray(fj, np.float32)
    err = np.abs(ft.numpy() - fj).max()
    assert err <= 1e-4 * np.abs(fj).max() + 2e-6 * float(f_dir.abs().max())
    assert np.abs(fj).max() > 10.0
    # without K-poly, the force-only kernels do the same arithmetic
    assert torch.equal(ft0, ft)


def test_energies_move_with_couple(pair):
    """E(couple +- h) term by term, and the coupling really moves the
    nonbonded terms."""
    js, ts, _ = pair
    h = np.float32(H)
    (_, tj_p), (_, tt_p), _ = _energies(js, ts, np.float32(COUPLE) + h)
    (_, tj_m), (_, tt_m), _ = _energies(js, ts, np.float32(COUPLE) - h)
    _terms_ok(tj_p, tt_p)
    _terms_ok(tj_m, tt_m)
    assert float(tt_p["coulomb"]) != float(tt_m["coulomb"])
    assert float(tt_p["recip"]) != float(tt_m["recip"])


def test_dhdl_matches_reference(pair):
    js, ts, _ = pair
    evals = ts.force_evals
    d_t = ts.dhdl()
    assert ts.force_evals == evals + 2
    d_j = js.dhdl()
    _, (_, tt), _ = _energies(js, ts, np.float32(COUPLE))
    floor = _floor(tt)
    assert np.isfinite(d_t)
    assert abs(d_t - d_j) <= DHDL_FLOORS * floor, (d_t, d_j, floor)


def test_dhdl_zero_without_coupling_and_water_refused():
    asys, v0 = _system()
    jt = asys.topology
    cm = np.zeros_like(np.asarray(jt.couple_mask))
    ts = FastSim(_port_top(jt, couple_mask=cm),
                 MdConfig(integrator=Integrator.langevin_middle(gamma=0.0),
                          hydrogen_constraint=HydrogenConstraint.shake(),
                          **KW),
                 asys.positions, box_extent=asys.box_extent, velocities=v0,
                 device="cpu")
    ts.configure_alchemical_window(0.3)
    assert float(ts.state.couple) == np.float32(0.7)
    evals = ts.force_evals
    assert ts.dhdl() == 0.0 and ts.force_evals == evals
    assert not ts._has_alch
    cm[jt.water_start] = 1.0
    with pytest.raises(ValueError, match="coupled waters"):
        FastSim(_port_top(jt, couple_mask=cm), ts.cfg, asys.positions,
                box_extent=asys.box_extent, velocities=v0, device="cpu")


def test_init_relaxation_runs_minimize():
    """velocities=None with max_init_relaxation_iters: init evaluates the
    force once, then minimizes (one period of 2 moves and its closing
    evaluation) and carries the force at the relaxed positions."""
    asys, _ = _system()
    a = _port(asys, None, max_init_relaxation_iters=2)
    assert a.force_evals == 1 + 2 + 1
    n = asys.topology.n_atoms_real
    assert np.abs(a.positions_unsorted()[:n] - asys.positions[:n]).max() \
        > 0.01
    with torch.no_grad():
        f, (e, _) = a._make_force_fn(True)(a.state.x, a.state)
    assert torch.equal(f, a.state.f) and float(e) == float(a.state.pe_last)


def test_minimize_matches_reference(pair):
    """Two rebuild periods of minimize (4 moves) from the same unrelaxed
    state; the states are restored afterwards."""
    js, ts, asys = pair
    js0, ts0 = js.state, ts.state
    try:
        evals = ts.force_evals
        e_t = ts.minimize(4)
        assert ts.force_evals - evals == 4 + 2
        e_j = js.minimize(4)
        x_t = ts.positions_unsorted()
        x_j = js.positions_unsorted()
        n = asys.topology.n_atoms_real
        assert np.abs(x_t[:n] - x_j[:n]).max() <= 1e-3
        assert np.abs(x_t[:n] - asys.positions[:n]).max() > 0.05
        # the carried force is the force at the final positions
        with torch.no_grad():
            f_end, (_, terms) = ts._make_force_fn(True)(ts.state.x,
                                                        ts.state)
        assert torch.equal(f_end, ts.state.f)
        assert abs(e_t - e_j) <= 1e-5 * max(abs(e_j),
                                            abs(float(terms["lj"])))
    finally:
        js.state, ts.state = js0, ts0


SAMPLES = [np.array([12.5, 11.0, 13.25, 12.0, 10.5, 12.75, 11.5]),
           np.array([3.0, 4.5, 2.25, 5.0]),
           np.array([-1.5, -2.0, -0.75, -1.25, -1.0, -2.5, -0.5, -1.75]),
           np.array([0.25, 0.5])]
LAMS = [0.0, 0.3, 0.7, 1.0]


def test_ti_functions_equal():
    for name in ("HYDRATION_LAMBDAS", "HYDRATION_EQUIL_STEPS",
                 "HYDRATION_PROD_STEPS", "HYDRATION_BOX_SIDE"):
        assert getattr(TA, name) == getattr(JA, name), name
    tw = [TA.LambdaWindow(lam=l, dhdl_samples=s)
          for l, s in zip(LAMS, SAMPLES)]
    jw = [JA.LambdaWindow(lam=l, dhdl_samples=s)
          for l, s in zip(LAMS, SAMPLES)]
    for a, b in zip(tw, jw):
        assert a.mean == b.mean
        for nb in (2, 3, 5):
            assert a.sem(nb) == b.sem(nb)
    # shuffled order: both sort by lambda
    order = [2, 0, 3, 1]
    assert TA.free_energy_ti_with_sem([tw[i] for i in order]) == \
        JA.free_energy_ti_with_sem([jw[i] for i in order])
    assert TA.LambdaWindow(0.1, np.array([1.0])).sem() == float("inf")
    with pytest.raises(TA.AlchemicalError):
        TA.free_energy_ti_with_sem(tw[:1])

    class Snap:
        def __init__(self, dhdl, e):
            self.dhdl = dhdl
            self.energy_data = (None if e is None else
                                type("E", (), {"energy_potential_nonbonded":
                                               e})())

    snaps = [Snap(1.5, -3.0), Snap(None, -4.5), Snap(2.25, None)]
    a = TA.collect_window(0.4, snaps)
    b = JA.collect_window(0.4, snaps)
    np.testing.assert_array_equal(a.dhdl_samples, b.dhdl_samples)
    assert a.lam == b.lam
    assert TA.mean_coupled_interaction_kcal(snaps) == \
        JA.mean_coupled_interaction_kcal(snaps)
    with pytest.raises(TA.AlchemicalError):
        TA.collect_window(0.4, [Snap(None, None)])
    with pytest.raises(TA.AlchemicalError):
        TA.mean_coupled_interaction_kcal([Snap(1.0, None)])


def test_methanol_spec_file_matches_the_jax_pipeline():
    """molchanica_tpu_torch/systems/data/methanol_gaff2.json is made by

        mol = molchanica_tpu.molecules.smiles.from_smiles("CO")
        molchanica_tpu.molecules.embed.embed_3d(mol, seed=0)
        json.dump(spec_json.spec_to_dict(mol.to_spec(strict=False)), fh,
                  indent=1)

    (deterministic); this test rebuilds it the same way and holds the file
    to it: parameters and topology lists equal, positions within 1e-6 A."""
    from molchanica_tpu.molecules.embed import embed_3d
    from molchanica_tpu.molecules.smiles import from_smiles

    mol = from_smiles("CO")
    embed_3d(mol, seed=0)
    ref = spec_json.spec_to_dict(mol.to_spec(strict=False))
    with open(spec_json.METHANOL_GAFF2) as fh:
        got = json.load(fh)
    assert set(got) == set(ref)
    for k in ref:
        if k != "positions":
            assert got[k] == ref[k], k
    np.testing.assert_allclose(np.asarray(got["positions"]),
                               np.asarray(ref["positions"]), rtol=0,
                               atol=1e-6)
    spec = spec_json.methanol()
    assert spec.n_atoms == 6 and len(spec.bonds) == 5
    assert len(spec.angles) == 7 and len(spec.dihedrals) == 3
    assert spec.hclusters == [(0, [2, 3, 4], [1.093] * 3), (1, [5], [0.974])]
    assert spec_json.spec_to_dict(spec) == got


@pytest.mark.slow
def test_run_sol_sim_fast_rehearsal():
    """The whole hydration protocol on the port at the tiny scale of
    tests/test_water_sol.py (LJ bead, 24 A box, 3 windows, 16 + 24 steps):
    ~715 force evaluations on the CPU (minimize(300) and 400 capped
    warm-up steps come first)."""
    from molchanica_tpu_torch.molecules.spec import MolSpec as TSpec
    from molchanica_tpu_torch.properties import (WaterSolMdProperties,
                                                 run_sol_sim_fast)

    bead = TSpec(masses=np.array([16.0]), charges=np.array([0.0]),
                 lj_sigma=np.array([3.73]), lj_eps=np.array([0.29]),
                 positions=np.zeros((1, 3)))
    props = run_sol_sim_fast(
        bead, box_side=24.0, lambdas=[0.0, 0.5, 1.0], equil_steps=16,
        prod_steps=24, dt_ps=0.001, dhdl_interval=8, seed=1,
        cfg_overrides=dict(lj_cutoff=6.0, coulomb_cutoff=6.0,
                           pme_grid=(24, 24, 24)), device="cpu")
    assert isinstance(props, WaterSolMdProperties)
    assert np.isfinite(props.dg_hydration_kcal)
    assert len(props.windows) == 3
    assert all(len(w.dhdl_samples) == 3 for w in props.windows)
    assert all(np.isfinite(w.dhdl_samples).all() for w in props.windows)
