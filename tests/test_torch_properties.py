"""Port parity: the batch workloads of molchanica_tpu_torch.properties and
systems/octanol.py against molchanica_tpu's.

The numpy parts equal the reference exactly on the same seeded inputs:
the octanol template and box packing, log_p, _water_contact_stats and the
mixing functions. The MD workloads (run_sol_sim, run_alchemical, the
crystal, the shrinking box's three entry points, the boundary layer)
build their MdSims from the reference's inputs exactly (the placed
system, box and config), and run against the reference at their JAX
tests' sizes with the same markers (`slow` where the JAX test is slow):
in float64, Langevin-middle at gamma 0 and both packages' MdSims started
from the same velocities, so the two integrate the same trajectory.
Where the port's relaxation keeps its lowest state (its one recorded
departure, ROADMAP Queue 3), the reference's end is checked against the
port's record and the reference goes on from the port's kept state. The
tolerances are in each test's docstring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.engine import MdSim as JMd
from molchanica_tpu.molecules.spec import MolSpec as JSpec
from molchanica_tpu.molecules.spec import assemble_system as j_assemble
from molchanica_tpu.parallel.replicas import ReplicaFarm as JFarm
from molchanica_tpu.properties import boundary_layer as JB
from molchanica_tpu.properties import crystal as JC
from molchanica_tpu.properties import logp as JL
from molchanica_tpu.properties import mixing as JM
from molchanica_tpu.properties import shrinking_box as JS
from molchanica_tpu.properties import water_sol as JW
from molchanica_tpu.systems import octanol as JO
from molchanica_tpu.systems.water import OPC as J_OPC
from molchanica_tpu_torch.constants import ACCEL_FACTOR, KB
from molchanica_tpu_torch.md import engine as TEng
from molchanica_tpu_torch.md.config import Integrator
from molchanica_tpu_torch.md.engine import MdSim
from molchanica_tpu_torch.molecules.spec import MolSpec
from molchanica_tpu_torch.molecules.spec import assemble_system
from molchanica_tpu_torch.parallel import replicas as TR
from molchanica_tpu_torch.parallel.replicas import ReplicaFarm
from molchanica_tpu_torch.properties import boundary_layer as TB
from molchanica_tpu_torch.properties import crystal as TC
from molchanica_tpu_torch.properties import logp as TL
from molchanica_tpu_torch.properties import mixing as TM
from molchanica_tpu_torch.properties import shrinking_box as TS
from molchanica_tpu_torch.properties import water_sol as TW
from molchanica_tpu_torch.systems import octanol as TO
from molchanica_tpu_torch.systems.water import OPC
from molchanica_tpu_torch.topology import STATIC_FIELDS, TENSOR_FIELDS

torch.set_num_threads(1)


ARRAY_FIELDS = ("masses", "charges", "lj_sigma", "lj_eps", "positions")


def _same_spec(a, b):
    """Every field of two MolSpecs equal: the arrays bit for bit, the
    bonded lists and flags as values."""
    da, db = vars(a), vars(b)
    assert da.keys() == db.keys()
    for k in da:
        if k in ARRAY_FIELDS:
            np.testing.assert_array_equal(np.asarray(da[k]),
                                          np.asarray(db[k]), err_msg=k)
        else:
            assert da[k] == db[k], k


@pytest.mark.parametrize("seed", [0, 3])
def test_octanol_equals_the_reference(seed):
    _same_spec(TO.build_octanol(seed), JO.build_octanol(seed))
    m_t, w_t = TO.pack_octanol_box(24.0, seed=seed)
    m_j, w_j = JO.pack_octanol_box(24.0, seed=seed)
    assert w_t == w_j and len(m_t) == len(m_j)
    for a, b in zip(m_t, m_j):
        _same_spec(a, b)


def test_pack_octanol_box_counts():
    """tests/test_logp.py's counts on the port."""
    mols, n_water = TO.pack_octanol_box(24.0, seed=1)
    expect = 356.0 / 46.0 ** 3 * 24.0 ** 3 * 0.85
    assert abs(len(mols) - expect) <= 1 and n_water > 0
    for m in mols:
        c = np.asarray(m.positions).mean(0)
        assert np.all(c > -3.0) and np.all(c < 27.0)
    m = TO.build_octanol()
    assert m.n_atoms == 27 and len(m.bonds) == m.n_atoms - 1
    np.testing.assert_allclose(float(np.sum(m.charges)), 0.0, atol=1e-12)


@pytest.mark.parametrize("dg", [(0.0, 1.3724), (-4.2, -7.9), (3.0, -1.5)])
def test_log_p(dg):
    assert TL.log_p(*dg, 298.15) == JL.log_p(*dg, 298.15)
    assert TL.log_p(0.0, 2.303 * 0.0019872 * 300.0, 300.0) == \
        pytest.approx(1.0, rel=1e-3)
    assert TL.LOGP_LAMBDAS == JL.LOGP_LAMBDAS
    assert TL.TEMP_DEFAULT == JL.TEMP_DEFAULT


def test_water_contact_stats():
    """The first-shell contacts and H-bond proxy on a methanol-like solute
    in a 20 A OPC box, both packages' assemblies from the same seed."""
    kw = dict(masses=[12.011, 1.008, 1.008, 1.008, 15.999, 1.008],
              charges=[0.12, 0.04, 0.04, 0.04, -0.60, 0.36],
              lj_sigma=[3.4, 2.47, 2.47, 2.47, 3.07, 0.0],
              lj_eps=[0.11, 0.016, 0.016, 0.016, 0.21, 0.0],
              positions=np.array([[0.0, 0, 0], [0.36, 1.03, 0],
                                  [0.36, -0.51, 0.89], [0.36, -0.51, -0.89],
                                  [-1.41, 0, 0], [-1.74, -0.9, 0]]) + 10.0)
    box = np.array([20.0] * 3)
    a_t = assemble_system([MolSpec(**kw)], box_extent=box, water_model=OPC,
                          alchemical_mol=0, seed=2)
    a_j = j_assemble([JSpec(**kw)], box_extent=box, water_model=J_OPC,
                     alchemical_mol=0, seed=2)
    np.testing.assert_array_equal(a_t.positions, np.asarray(a_j.positions))
    rng = np.random.default_rng(4)
    x = np.asarray(a_j.positions) + rng.normal(0, 0.3, a_j.positions.shape)
    got = TW._water_contact_stats(a_t, x)
    ref = JW._water_contact_stats(a_j, x)
    assert got == ref and got[0] > 0 and got[1] > 0


def test_mixing_functions():
    rng = np.random.default_rng(0)
    box = np.array([30.0] * 3)
    water = rng.uniform(0, 30, (400, 3))
    for sol in (rng.uniform(0, 30, (8, 3)),
                np.array([15.0, 15, 15]) + rng.normal(0, 1.2, (8, 3))):
        assert dataclasses.asdict(TM.mixing_diagnostics(sol, water, box)) \
            == dataclasses.asdict(JM.mixing_diagnostics(sol, water, box))
    sol = rng.uniform(0, 32, (27 * 3, 3))
    w = rng.uniform(0, 32, (900, 3))
    box = np.array([32.0] * 3)
    assert TM.compute_solubility(sol, 3, w, box) == \
        JM.compute_solubility(sol, 3, w, box)
    frames = [rng.uniform(0, 32, (9, 3)) for _ in range(3)]
    solvent = [rng.uniform(0, 32, (300, 3)) for _ in range(3)]
    assert TM.compute_solubility_trajectory(frames, 3, solvent, box) == \
        JM.compute_solubility_trajectory(frames, 3, solvent, box)
    mol = np.array([[19.5, 10, 10], [0.5, 10, 10]])
    np.testing.assert_array_equal(
        TM.solute_mol_centers(mol, 2, np.array([20.0] * 3)),
        JM.solute_mol_centers(mol, 2, np.array([20.0] * 3)))
    for v in (0.0, 0.1, 0.5, 1.0):
        assert TM.log_expanded_score(v) == JM.log_expanded_score(v)
        assert TM.map_to_aqsoldb(v) == JM.map_to_aqsoldb(v)
    for obs, exp in ((0, 10.0), (10, 10.0), (100, 10.0), (3, 0.5)):
        assert TM.occupancy_count_score(obs, exp) == \
            JM.occupancy_count_score(obs, exp)
    for b in (np.array([8.0] * 3), np.array([40.0, 30.0, 20.0])):
        assert TM.adapted_kernel_sigmas(b) == JM.adapted_kernel_sigmas(b)
        assert TM.valid_solubility_cell(b) == JM.valid_solubility_cell(b)
    assert not TM.valid_solubility_cell(None)


# ---------------------------------------------------------------------------
# The MD workloads against the reference's
# ---------------------------------------------------------------------------

JAX_ONLY_CFG = {"use_scan_chunks", "pme_every"}


def _v0(masses, dof_mask, temp):
    """The first velocities both packages' MdSims start from: a
    Maxwell-Boltzmann draw at `temp` made with numpy from a fixed seed
    (each package draws its own otherwise)."""
    rng = np.random.default_rng(7)
    m = np.maximum(np.asarray(masses, np.float64), 1e-6)
    sd = np.sqrt(KB * temp * ACCEL_FACTOR / m)
    return rng.normal(size=(m.size, 3)) * sd[:, None] \
        * np.asarray(dof_mask, np.float64)[:, None]


def _top64(top):
    """The reference's float32 topology with its float fields in float64,
    as the port's MdSim casts its own float32 topology."""
    return top.replace(**{
        f: jnp.asarray(np.asarray(getattr(top, f)), jnp.float64)
        for f in TENSOR_FIELDS
        if np.issubdtype(np.asarray(getattr(top, f)).dtype, np.floating)})


def _port_np(t):
    return t.detach().cpu().numpy()


class _Stop(Exception):
    """Raised where a workload builds its MdSim, to end it at its set-up."""


class _Twins:
    """What both packages' workloads build: per side ("ref", "port") each
    MdSim's inputs (topology, config, positions, box) and its step calls
    (dt, steps, force cap, box side before the call), and each farm."""

    def __init__(self):
        self.stop = False
        self.sims = {"ref": [], "port": []}
        self.farms = {"ref": [], "port": []}

    def md(self, base, side, to_np):
        tw = self

        class Recorded(base):
            def __init__(self, top, cfg, x0, box_extent=None, **kw):
                entry = dict(top=top, cfg=cfg, calls=[],
                             x0=np.array(to_np(x0) if torch.is_tensor(x0)
                                         else x0, np.float64),
                             box=None if box_extent is None
                             else np.array(box_extent, np.float64))
                tw.sims[side].append(entry)
                if tw.stop:
                    raise _Stop
                if side == "ref" and cfg.dtype == "float64":
                    top = _top64(top)
                kw.setdefault("velocities", _v0(
                    to_np(top.masses), to_np(top.dof_mask), cfg.temp_target))
                super().__init__(top, cfg, x0, box_extent=box_extent, **kw)
                self._entry, self._stepping = entry, False
                entry["sim"] = self
                if side == "port":
                    entry["x_relaxed"] = to_np(self.state.positions).copy()
                else:
                    tw.hand_over(self, entry)

            def step(self, dt_ps, n_steps=1, record_energy=False,
                     force_cap=None):
                # the caller's calls only (the reference's step calls
                # itself once per chunk)
                if not self._stepping:
                    box = self.state.box
                    self._entry["calls"].append(
                        (dt_ps, n_steps, force_cap,
                         None if box is None else float(to_np(box)[0])))
                outer, self._stepping = self._stepping, True
                try:
                    return super().step(dt_ps, n_steps, record_energy,
                                        force_cap)
                finally:
                    self._stepping = outer
        return Recorded

    def hand_over(self, sim, entry):
        """The port's one recorded departure in the relaxation (ROADMAP
        Queue 3): where the path that ran ends above the reference's
        acceptance bound, the port keeps the lowest state the path
        evaluated and the reference the path's end. There the reference's
        MdSim (built after the port's twin) records the energy of its own
        end, to be held against the port's e_end, and goes on from the
        port's kept state."""
        k = len(self.sims["ref"]) - 1
        if k >= len(self.sims["port"]):
            return
        twin = self.sims["port"][k]
        log = twin["sim"].relax_log
        if not log or log["kept"] != "lowest":
            return
        s = sim.state
        entry["e_end"] = float(
            jax.jit(sim.force_fn)(s.positions, s.box, s.couple)[1][0])
        x = twin["x_relaxed"]
        sim.state = s.replace(positions=jnp.asarray(x, s.positions.dtype))
        if sim.method == "cells_pme":
            sim._build_force_paths(x)

    def farm(self, base, side):
        tw = self

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                tw.farms[side].append(self)
        return Recorded


@pytest.fixture
def twins(monkeypatch):
    """Both packages' MdSim and ReplicaFarm in every workload module
    replaced by recording subclasses. Unless twins.stop is set (then an
    MdSim raises _Stop once recorded), each MdSim starts from _v0 and the
    reference's from its topology in float64 where the config is float64;
    the reference's isolated-molecule energy (crystal) takes the same."""
    tw = _Twins()
    jmd, tmd = tw.md(JMd, "ref", np.asarray), tw.md(MdSim, "port", _port_np)
    for mod in (JW, JL, JC, JS, JB):
        monkeypatch.setattr(mod, "MdSim", jmd)
    for mod in (TEng, TL, TC, TS, TB):
        monkeypatch.setattr(mod, "MdSim", tmd)
    jfarm, tfarm = tw.farm(JFarm, "ref"), tw.farm(ReplicaFarm, "port")
    for mod in (JW, JL):
        monkeypatch.setattr(mod, "ReplicaFarm", jfarm)
    for mod in (TR, TL):
        monkeypatch.setattr(mod, "ReplicaFarm", tfarm)
    snap = JC.compute_energy_snapshot

    def snap64(top, cfg, x, **kw):
        return snap(_top64(top) if cfg.dtype == "float64" else top, cfg, x,
                    **kw)
    monkeypatch.setattr(JC, "compute_energy_snapshot", snap64)
    return tw


def _same_setup(e_j, e_t):
    """Two recorded MdSim inputs equal: the topology's arrays and statics,
    the positions and the box bit for bit, the configs field by field (the
    reference's JAX-only fields aside)."""
    jt, tt = e_j["top"], e_t["top"]
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(_port_np(getattr(tt, f)),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(tt, f) == getattr(jt, f), f
    np.testing.assert_array_equal(e_t["x0"], e_j["x0"])
    np.testing.assert_array_equal(e_t["box"], e_j["box"])
    cj, ct = dataclasses.asdict(e_j["cfg"]), dataclasses.asdict(e_t["cfg"])
    assert set(cj) - set(ct) == JAX_ONLY_CFG and set(ct) <= set(cj)
    assert ct == {k: cj[k] for k in ct}


def _tiny_solute(spec=MolSpec):
    """tests/test_water_sol.py's neutral LJ bead."""
    return spec(masses=np.array([16.0]), charges=np.array([0.0]),
                lj_sigma=np.array([3.73]), lj_eps=np.array([0.29]),
                positions=np.zeros((1, 3)))


def _small_mol(spec=MolSpec):
    """tests/test_properties_suite.py's methanol-like solute."""
    return spec(
        masses=[12.011, 1.008, 1.008, 1.008, 15.999, 1.008],
        charges=[0.12, 0.04, 0.04, 0.04, -0.60, 0.36],
        lj_sigma=[3.4, 2.47, 2.47, 2.47, 3.07, 0.0],
        lj_eps=[0.11, 0.016, 0.016, 0.016, 0.21, 0.0],
        positions=np.array([[0.0, 0, 0], [0.36, 1.03, 0],
                            [0.36, -0.51, 0.89], [0.36, -0.51, -0.89],
                            [-1.41, 0, 0], [-1.74, -0.9, 0]]),
        bonds=[(0, 1, 340.0, 1.09), (0, 2, 340.0, 1.09),
               (0, 3, 340.0, 1.09), (0, 4, 320.0, 1.41),
               (4, 5, 553.0, 0.96)],
        angles=[(1, 0, 2, 35.0, 1.911), (1, 0, 3, 35.0, 1.911),
                (2, 0, 3, 35.0, 1.911), (1, 0, 4, 50.0, 1.911),
                (2, 0, 4, 50.0, 1.911), (3, 0, 4, 50.0, 1.911),
                (0, 4, 5, 55.0, 1.894)],
        hclusters=[(0, [1, 2, 3], [1.09] * 3), (4, [5], [0.96])])


# the reference's and the port's side of each workload: (module, MolSpec,
# Integrator, extra keyword arguments)
SIDES = {"ref": (dict(water_sol=JW, logp=JL, crystal=JC, shrinking_box=JS,
                      boundary_layer=JB), JSpec, JInt, {}),
         "port": (dict(water_sol=TW, logp=TL, crystal=TC, shrinking_box=TS,
                       boundary_layer=TB), MolSpec, Integrator,
                  dict(device="cpu"))}


def _nve(side, **cfg):
    """cfg_overrides of a deterministic run: Langevin-middle at gamma 0
    (no friction, no noise), so both packages integrate the same
    trajectory from the same start."""
    return dict(cfg, integrator=SIDES[side][2].langevin_middle(gamma=0.0))


def _run(side, name, fn, *mols, **kw):
    """Call workload `fn` of module `name` on one side, with the solutes
    `mols` (builders taking the side's MolSpec class)."""
    mods, spec, _, extra = SIDES[side]
    args = [m(spec) if callable(m) else [x(spec) for x in m] for m in mols]
    return getattr(mods[name], fn)(*args, **kw, **extra)


SOL_KW = dict(box_side=16.0, lambdas=[0.0, 0.5, 1.0], equil_steps=20,
              prod_steps=30, dt_ps=0.001, dhdl_interval=5, seed=1)
SOL_CFG = dict(lj_cutoff=6.0, coulomb_cutoff=6.0,
               max_init_relaxation_iters=80, direct_backend="auto")
ALCH_KW = dict(water_box_side=18.0, octanol_box_side=19.5,
               lambdas=[0.0, 0.5, 1.0], equil_steps=30, prod_steps=60,
               dt_ps=0.001, seed=3)
ALCH_CFG = dict(lj_cutoff=6.0, coulomb_cutoff=6.0,
                max_init_relaxation_iters=150)


def _setup_calls(name):
    """(module, function, solutes, keyword arguments) of each workload's
    set-up case: the JAX tests' sizes, and run_sol_sim at the protocol's
    defaults (methanol-like solute, 35 A box)."""
    return {
        "run_sol_sim": ("water_sol", "run_sol_sim", [_tiny_solute],
                        dict(SOL_KW, cfg_overrides=SOL_CFG)),
        "run_sol_sim_protocol": ("water_sol", "run_sol_sim", [_small_mol],
                                 {}),
        "crystal": ("crystal", "run_crystal_sim", [_small_mol],
                    dict(requested_copies=8, n_steps=200, dt_ps=0.001,
                         cfg_overrides=dict(max_init_relaxation_iters=150))),
        "shrinking_box": ("shrinking_box", "run_shrinking_box_sim",
                          [[_small_mol] * 10],
                          dict(target_density_g_cm3=0.7, steps_per_stage=60,
                               cfg_overrides=dict(
                                   max_init_relaxation_iters=100))),
        "shrinking_box_slab": ("shrinking_box", "run_shrinking_box_sim",
                               [[_small_mol] * 8],
                               dict(target_density_g_cm3=0.55,
                                    steps_per_stage=40, mode="slab",
                                    solute_indices=[0, 1, 2, 3])),
        "boundary_layer": ("boundary_layer", "run_boundary_layer_sol_sim",
                           [_small_mol],
                           dict(slab_waters=80, box_xy=14.0, box_z=40.0,
                                n_steps=450, cfg_overrides=dict(
                                    lj_cutoff=6.5, coulomb_cutoff=6.5))),
    }[name]


@pytest.mark.parametrize("case", ["run_sol_sim", "run_sol_sim_protocol",
                                  "crystal", "shrinking_box",
                                  "shrinking_box_slab", "boundary_layer"])
def test_workload_setup_equals_the_reference(twins, case):
    """Each workload builds its MdSim from the reference's inputs: the
    placed solute, water, copies or slab (the topology, positions and box
    bit for bit) and the same MdConfig."""
    name, fn, mols, kw = _setup_calls(case)
    twins.stop = True
    for side in ("ref", "port"):
        with pytest.raises(_Stop):
            _run(side, name, fn, *mols, **kw)
    (e_j,), (e_t,) = twins.sims["ref"], twins.sims["port"]
    _same_setup(e_j, e_t)


def test_run_alchemical_setup_equals_the_reference(twins, monkeypatch):
    """run_alchemical's two phases get the reference's assembled systems
    (the solute in water; the solute in wet octanol) and arguments, and
    LogP follows from their dGs as in the reference; _phase_free_energy
    builds the reference's MdSim."""
    seen = {"ref": [], "port": []}
    j_phase, t_phase = JL._phase_free_energy, TL._phase_free_energy
    for side, mod in (("ref", JL), ("port", TL)):
        def phase(asys, *a, _side=side, _mod=mod, **kw):
            seen[_side].append((asys, a, kw))
            return _mod.FreeEnergyEstimate(-2.5 * len(seen[_side]), 0.1)
        monkeypatch.setattr(mod, "_phase_free_energy", phase)
    kw = dict(ALCH_KW, cfg_overrides=ALCH_CFG)
    res = {side: _run(side, "logp", "run_alchemical", _small_mol, **kw)
           for side in ("ref", "port")}
    assert res["port"].logp == res["ref"].logp
    assert len(seen["ref"]) == len(seen["port"]) == 2
    twins.stop = True
    for (aj, a_j, k_j), (at, a_t, k_t) in zip(seen["ref"], seen["port"]):
        assert a_t == a_j and k_t == {**k_j, "device": "cpu"}
        np.testing.assert_array_equal(at.positions, np.asarray(aj.positions))
        np.testing.assert_array_equal(at.box_extent, aj.box_extent)
        with pytest.raises(_Stop):
            j_phase(aj, *a_j, **k_j)
        with pytest.raises(_Stop):
            t_phase(at, *a_t, **k_t)
    for e_j, e_t in zip(twins.sims["ref"], twins.sims["port"]):
        _same_setup(e_j, e_t)


def _same_calls(tw, rtol=1e-12):
    """Both sides' MdSims relaxed alike and made the same step calls (dt,
    steps, force cap) on the same box sides (rel rtol): the same schedule.
    Where the port kept its lowest state (_Twins.hand_over), the
    reference's end equals the port's e_end (rel 1e-9): the same path to
    its end."""
    for e_j, e_t in zip(tw.sims["ref"], tw.sims["port"], strict=True):
        log = e_t["sim"].relax_log
        assert ("e_end" in e_j) == bool(log and log["kept"] == "lowest")
        if "e_end" in e_j:
            np.testing.assert_allclose(e_j["e_end"], log["e_end"],
                                       rtol=1e-9, atol=0)
        cj, ct = e_j["calls"], e_t["calls"]
        assert [c[:3] for c in ct] == [c[:3] for c in cj]
        np.testing.assert_allclose([c[3] for c in ct], [c[3] for c in cj],
                                   rtol=rtol, atol=0)


def _same_positions(tw, atol):
    """Both sides' MdSims end at the same positions (within atol A)."""
    for k, (e_j, e_t) in enumerate(zip(tw.sims["ref"], tw.sims["port"],
                                       strict=True)):
        np.testing.assert_allclose(_port_np(e_t["sim"].state.positions),
                                   np.asarray(e_j["sim"].state.positions),
                                   rtol=0, atol=atol, err_msg=f"MdSim {k}")


def _same_windows(w_j, w_t, rtol):
    """The same lambdas and dH/dlambda samples, each within rtol of the
    largest magnitude of its window."""
    assert [w.lam for w in w_t] == [w.lam for w in w_j]
    for a, b in zip(w_j, w_t):
        assert a.dhdl_samples.shape == b.dhdl_samples.shape
        scale = np.abs(a.dhdl_samples).max()
        assert np.abs(b.dhdl_samples - a.dhdl_samples).max() <= rtol * scale


def test_run_sol_sim_tiny(twins):
    """tests/test_water_sol.py::test_run_sol_sim_tiny's arguments in
    float64 at gamma 0 (_nve), both packages from the same first
    velocities: the step schedule equal, positions after the warm-ups
    1e-10 A and at the farm's end 1e-8 A, every window's dH/dlambda
    samples within 1e-6 of its largest magnitude, dG and SEM rel 1e-6, the
    descriptors equal. The port's account: 20 + 30 farm steps of 3
    replicas, the relaxation in one block of 80."""
    out = {side: _run(side, "water_sol", "run_sol_sim", _tiny_solute,
                      **SOL_KW, cfg_overrides=_nve(side, dtype="float64",
                                                   **SOL_CFG))
           for side in ("port", "ref")}
    pj, pt = out["ref"], out["port"]
    assert isinstance(pt, TW.WaterSolMdProperties)
    _same_calls(twins)
    _same_positions(twins, 1e-10)
    (fj,), (ft,) = twins.farms["ref"], twins.farms["port"]
    np.testing.assert_allclose(_port_np(ft.x), np.asarray(fj.x), rtol=0,
                               atol=1e-8)
    _same_windows(pj.windows, pt.windows, 1e-6)
    assert all(len(w.dhdl_samples) == 5 for w in pt.windows)
    np.testing.assert_allclose(
        [pt.dg_hydration_kcal, pt.dg_sem_kcal,
         pt.mean_coupled_interaction_kcal],
        [pj.dg_hydration_kcal, pj.dg_sem_kcal,
         pj.mean_coupled_interaction_kcal], rtol=1e-6, atol=0)
    assert (pt.mean_n_water_contacts, pt.mean_n_h_bonds) == \
        (pj.mean_n_water_contacts, pj.mean_n_h_bonds)
    rm = pt.run_metrics
    assert rm["farm_steps"] == 20 + 30 and rm["n_replicas"] == 3
    assert rm["relax"]["block"] == 80 and rm["finite"]


@pytest.mark.slow
def test_run_alchemical_tiny(twins):
    """tests/test_logp.py::test_run_alchemical_tiny's arguments in float64
    at gamma 0 (_nve): each phase's schedule, positions 1e-8 A, windows
    within 1e-6 of their largest |dH/dlambda|, dG and SEM rel 1e-6, LogP
    abs 1e-6."""
    out = {side: _run(side, "logp", "run_alchemical", _small_mol, **ALCH_KW,
                      cfg_overrides=_nve(side, dtype="float64", **ALCH_CFG))
           for side in ("port", "ref")}
    rj, rt = out["ref"], out["port"]
    assert isinstance(rt, TL.LogPResult) and len(rt.octanol.windows) == 3
    _same_calls(twins)
    _same_positions(twins, 1e-8)
    for fj, ft in zip(twins.farms["ref"], twins.farms["port"], strict=True):
        np.testing.assert_allclose(_port_np(ft.x), np.asarray(fj.x),
                                   rtol=0, atol=1e-8)
    for ph in ("water", "octanol"):
        a, b = getattr(rj, ph), getattr(rt, ph)
        _same_windows(a.windows, b.windows, 1e-6)
        np.testing.assert_allclose([b.dg_kcal_mol, b.dg_sem_kcal_mol],
                                   [a.dg_kcal_mol, a.dg_sem_kcal_mol],
                                   rtol=1e-6, atol=0)
    assert abs(rt.logp - rj.logp) <= 1e-6 and rt.temp_k == rj.temp_k
    assert np.isfinite(rt.logp) and rt.water.dg_sem_kcal_mol >= 0.0


@pytest.mark.slow
def test_crystal_sim_small(twins):
    """tests/test_properties_suite.py::test_crystal_sim_small's arguments
    at gamma 0 (_nve): the same copies, box and schedule, positions 1e-8
    A, the energies and temperature rel 1e-9, the contacts equal."""
    out = {side: _run(side, "crystal", "run_crystal_sim", _small_mol,
                      requested_copies=8, n_steps=200, dt_ps=0.001,
                      cfg_overrides=_nve(side,
                                         max_init_relaxation_iters=150))
           for side in ("port", "ref")}
    (dj, _), (dt, _) = out["ref"], out["port"]
    _same_calls(twins)
    _same_positions(twins, 1e-8)
    assert (dt.copy_count, dt.box_side_a, dt.mean_intermolecular_contacts) \
        == (dj.copy_count, dj.box_side_a, dj.mean_intermolecular_contacts)
    assert dt.copy_count >= 4 and dt.cohesive_energy_kcal_per_mol < 5.0
    np.testing.assert_allclose(
        [dt.cohesive_energy_kcal_per_mol, dt.energy_total_kcal,
         dt.energy_isolated_kcal, dt.temperature_k],
        [dj.cohesive_energy_kcal_per_mol, dj.energy_total_kcal,
         dj.energy_isolated_kcal, dj.temperature_k], rtol=1e-9, atol=0)


def _same_shrink(dj, dt, atol):
    """Two ShrinkingBoxMdData equal: the shrink steps, the final box,
    density and temperature rel 1e-9, positions atol, the mixing
    descriptors rel 1e-9."""
    assert dt.shrink_steps == dj.shrink_steps
    np.testing.assert_allclose(
        [dt.final_box_side_a, dt.final_density_g_cm3, dt.temperature_k],
        [dj.final_box_side_a, dj.final_density_g_cm3, dj.temperature_k],
        rtol=1e-9, atol=0)
    np.testing.assert_allclose(dt.positions, dj.positions, rtol=0,
                               atol=atol)
    assert (dt.mixing is None) == (dj.mixing is None)
    if dt.mixing is not None:
        mj, mt = dataclasses.asdict(dj.mixing), dataclasses.asdict(dt.mixing)
        assert mt.keys() == mj.keys()
        np.testing.assert_allclose([mt[k] for k in mt], [mj[k] for k in mt],
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.slow
def test_shrinking_box_reaches_density(twins):
    """tests/test_properties_suite.py's arguments at gamma 0 (_nve): the
    same shrink stages (step calls and box sides rel 1e-12), positions
    1e-8 A, the final box, density and temperature rel 1e-9."""
    kw = dict(target_density_g_cm3=0.7, steps_per_stage=60)
    out = {side: _run(side, "shrinking_box", "run_shrinking_box_sim",
                      [_small_mol] * 10, **kw,
                      cfg_overrides=_nve(side,
                                         max_init_relaxation_iters=100))
           for side in ("port", "ref")}
    _same_calls(twins)
    _same_positions(twins, 1e-8)
    _same_shrink(out["ref"], out["port"], 1e-8)
    assert out["port"].shrink_steps > 0
    assert out["port"].final_density_g_cm3 > 0.6


def test_shrinking_box_slab_mode_and_batch(twins):
    """tests/test_properties_suite.py's slab mode, batch runner and packing
    primitive (heavy there, not slow) at gamma 0 (_nve), each against the
    reference on the same arguments: the same shrink stages, positions
    1e-8 A, box, density and temperature rel 1e-9, the mixing
    descriptors rel 1e-9."""
    runs = [("run_shrinking_box_sim", [[_small_mol] * 8],
             dict(target_density_g_cm3=0.55, steps_per_stage=40,
                  mode="slab", solute_indices=[0, 1, 2, 3]), 80),
            ("run_on_select_mols", [[[_small_mol] * 4]],
             dict(target_density_g_cm3=0.5, steps_per_stage=30), 60),
            ("pack_to_density", [[_small_mol] * 4],
             dict(target_density_g_cm3=0.5, steps_per_stage=30), 60)]
    for fn, mols, kw, n_relax in runs:
        out = {}
        for side in ("port", "ref"):
            mods, spec, _, extra = SIDES[side]
            args = [[[m(spec) for m in ml] for ml in a] if fn ==
                    "run_on_select_mols" else [m(spec) for m in a]
                    for a in mols]
            out[side] = getattr(mods["shrinking_box"], fn)(
                *args, **kw, **extra, cfg_overrides=_nve(
                    side, max_init_relaxation_iters=n_relax))
        dj, dt = out["ref"], out["port"]
        if fn == "run_shrinking_box_sim":
            _same_shrink(dj, dt, 1e-8)
            assert dt.mixing is not None and dt.final_density_g_cm3 > 0.45
        elif fn == "run_on_select_mols":
            assert len(dt) == len(dj) == 1
            _same_shrink(dj[0], dt[0], 1e-8)
        else:
            np.testing.assert_allclose(dt[0], dj[0], rtol=0, atol=1e-8)
            np.testing.assert_allclose(dt[1], dj[1], rtol=1e-9, atol=0)
            assert dt[0].shape[1] == 3 and dt[1].shape == (3,)
    _same_calls(twins)
    _same_positions(twins, 1e-8)


@pytest.mark.slow
def test_boundary_layer_profile(twins):
    """tests/test_properties_suite.py::test_boundary_layer_profile's
    arguments at gamma 0 (_nve): the same slab and schedule, positions
    1e-4 A, the density profile equal bin for bin, the Gibbs surface and
    surface affinity equal, depth and temperature rel 1e-5. The slab is
    chaotic: the two trajectories part by 7e-12 A after the warm-up and
    grow about tenfold every 60 steps to 1.3e-5 A after the 450 (measured
    on the CPU, both packages float64)."""
    out = {side: _run(side, "boundary_layer", "run_boundary_layer_sol_sim",
                      _small_mol, slab_waters=80, box_xy=14.0, box_z=40.0,
                      n_steps=450, cfg_overrides=_nve(
                          side, max_init_relaxation_iters=100,
                          lj_cutoff=6.5, coulomb_cutoff=6.5))
           for side in ("port", "ref")}
    dj, dt = out["ref"], out["port"]
    _same_calls(twins)
    _same_positions(twins, 1e-4)
    np.testing.assert_array_equal(dt.density_profile, dj.density_profile)
    np.testing.assert_array_equal(dt.profile_z, dj.profile_z)
    prof = dt.density_profile
    assert prof.sum() > 0 and 0.0 <= dt.surface_affinity <= 1.0
    assert prof[: len(prof) // 3].sum() > 3 * prof[-len(prof) // 4:].sum()
    assert (dt.gibbs_surface_z_a, dt.surface_affinity) == \
        (dj.gibbs_surface_z_a, dj.surface_affinity)
    np.testing.assert_allclose([dt.solute_depth_a, dt.temperature_k],
                               [dj.solute_depth_a, dj.temperature_k],
                               rtol=1e-5, atol=0)


def _farm_temperatures(farm, to_np):
    """[R] final temperatures of a farm (K), as MdSim.temperature()."""
    top = farm.sim.top
    v = np.asarray(to_np(farm.v), np.float64)
    m = np.asarray(to_np(top.masses), np.float64)
    d = np.asarray(to_np(top.dof_mask), np.float64)
    ke = 0.5 * (m * d * (v * v).sum(-1)).sum(-1) / ACCEL_FACTOR
    ndof = max(3.0 * d.sum() - farm.sim.n_constraints - 3.0, 1.0)
    return 2.0 * ke / (KB * ndof)


@pytest.mark.slow
def test_reference_run_sol_sim_collapses_at_the_chip_counts(monkeypatch):
    """The witness for chip_smoke.py's window gate in phases H and I
    (WINDOW_BLOWUP_K): the reference's own run_sol_sim, at phase H's seed
    and its step counts before they were cut to FIRE 100 and 20 + 22 (FIRE
    over 400 iterations, 40 + 40 capped warm-up steps, 40 + 66 farm steps
    with a recorded step after every 10, seed 3) and its own float32 MdConfig, on the committed methanol in a 28 A
    OPC box (2,898 sites, the smallest box past 2,048, so that it runs
    cells_pme with clusters as phase H's 35 A box does). Its end-point
    windows stay finite and below 1e4 K; at least one intermediate window
    blows up past 1e4 K, the collapse its linear alchemical Coulomb
    allows there. So the port's gate asks no more of an intermediate
    window than the reference gives. Prints each window's final T."""
    from molchanica_tpu_torch.molecules.spec_json import methanol

    tw = _Twins()
    monkeypatch.setattr(JW, "ReplicaFarm", tw.farm(JFarm, "ref"))
    props = JW.run_sol_sim(JSpec(**vars(methanol())), box_side=28.0,
                           equil_steps=40, prod_steps=66, dhdl_interval=10,
                           seed=3)
    (farm,) = tw.farms["ref"]
    assert farm.sim.method == "cells_pme" \
        and farm.sim._nbr_backend == "clusters"
    temps = _farm_temperatures(farm, np.asarray)
    lams = np.asarray([w.lam for w in props.windows])
    print("reference run_sol_sim, 28 A box, final T per window:",
          dict(zip(np.round(lams, 3).tolist(), np.round(temps, 2).tolist())),
          "dG", props.dg_hydration_kcal)
    assert np.isfinite(np.asarray(farm.x)).all()
    ends = (lams == 0.0) | (lams == 1.0)
    assert (temps[ends] < 1e4).all()
    assert (temps[~ends] > 1e4).any()
