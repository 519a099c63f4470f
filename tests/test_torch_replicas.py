"""Port parity: the replica farm (molchanica_tpu_torch.parallel.replicas)
against molchanica_tpu's ReplicaFarm, and MdSim's relaxation in the
reference's block structure.

Tolerances (float64 unless named): on tests/test_replicas.py's LJ bath (21
sites, allpairs_cutoff, 4 replicas at couples [1, .6, .3, 0],
Langevin-middle at gamma 0, 10 steps with dH/dlambda recorded) positions
1e-8 A, energies rel 1e-9, dH/dlambda rel 1e-6 of its largest magnitude;
on the 1,312-site system of tests/test_torch_mdsim_default.py (clusters,
the solute coupled, 2 replicas, 3 steps of 0.5 fs, the reference's
rebuild fed placed M rows, 2 steps and a recorded one) the same. The K2
farm (float32, the kernel's plain version on the CPU) against the
reference's cluster farm over the same steps: positions 5e-3 A (the step
tolerance of tests/test_torch_mdsim_default.py), energies rel 1e-5 of |E|
plus the direct space's |e| sums. Each replica of a farm against an
R = 1 farm with the same couple, start and noise, and a farm cut over two
devices against one chunk: 1e-12 A. The relaxation over 150 iterations
(two blocks of 100: the reference's block length is min(n, 100) and it
runs ceil(n / 100) of them) on tests/test_water_sol.py's system in a 13
A box (allpairs_cutoff) against the reference MdSim's own relaxation: energies
rel 1e-9, positions 1e-8 A; the fallback path (40 iterations) against
fire_minimize_hostloop the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.energy import apply_virtual_sites as j_place
from molchanica_tpu.md.engine import MdSim as JMd
from molchanica_tpu.md import minimize as j_minimize
from molchanica_tpu.md.minimize import fire_minimize as j_fire
from molchanica_tpu.md.minimize import fire_minimize_hostloop
from molchanica_tpu.molecules.spec import MolSpec as JSpec
from molchanica_tpu.molecules.spec import assemble_system as j_assemble
from molchanica_tpu.parallel.replicas import ReplicaFarm as JFarm
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu.systems.water import OPC
from molchanica_tpu_torch.md import engine as TEng
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.engine import MdSim
from molchanica_tpu_torch.ops import direct_force as TDF
from molchanica_tpu_torch.parallel.replicas import ReplicaFarm
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)
from jax_reference import kernel_slope, reference_scales

torch.set_num_threads(1)


def _tops(jt, dtype):
    """(reference topology, port topology) in `dtype`; the reference's
    float64 twin casts every float field."""
    fields = {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS}
    statics = {s: getattr(jt, s) for s in STATIC_FIELDS}
    if dtype == "float64":
        jt = jt.replace(**{f: jnp.asarray(a, jnp.float64)
                           for f, a in fields.items()
                           if np.issubdtype(a.dtype, np.floating)})
    return jt, topology_from_numpy(fields, statics,
                                   dtype=getattr(torch, dtype))


def _coupled(jt, tt):
    """The solute (molecule 0) as the coupled molecule."""
    cm = (np.asarray(jt.mol_id) == 0) * np.asarray(jt.atom_mask)
    return (jt.replace(couple_mask=jnp.asarray(cm, jt.masses.dtype)),
            tt.__class__(**{**vars(tt), "couple_mask": torch.tensor(
                cm, dtype=tt.masses.dtype)}))


# ---------------------------------------------------------------------------
# The LJ bath of tests/test_replicas.py
# ---------------------------------------------------------------------------

LJ_KW = dict(temp_target=120.0, lj_cutoff=5.0, coulomb_cutoff=5.0,
             dtype="float64", zero_com_drift=False, seed=3)
COUPLES = [1.0, 0.6, 0.3, 0.0]


@pytest.fixture(scope="module")
def bath():
    """(reference MdSim after its 100-iteration FIRE, port MdSim on the
    same state) at Langevin-middle gamma 0."""
    rng = np.random.default_rng(1)
    baths = [JSpec(masses=[39.9], charges=[0.0], lj_sigma=[3.3],
                   lj_eps=[0.25], positions=rng.uniform(0, 12, (1, 3)))
             for _ in range(20)]
    solute = JSpec(masses=[39.9], charges=[0.0], lj_sigma=[3.3],
                   lj_eps=[0.25], positions=np.array([[6.0, 6.0, 6.0]]))
    asys = j_assemble([solute] + baths, box_extent=np.array([12.0] * 3),
                      alchemical_mol=0)
    jt, tt = _tops(asys.topology, "float64")
    js = JMd(jt, JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                      max_init_relaxation_iters=100, **LJ_KW),
             asys.positions, box_extent=asys.box_extent,
             method="allpairs_cutoff")
    s = js.state
    ts = MdSim(tt, MdConfig(integrator=Integrator.langevin_middle(gamma=0.0),
                            max_init_relaxation_iters=None, **LJ_KW),
               np.asarray(s.positions), box_extent=asys.box_extent,
               velocities=np.asarray(s.velocities),
               method="allpairs_cutoff", device="cpu")
    return js, ts


def test_farm_matches_the_reference_on_the_lj_bath(bath):
    js, ts = bath
    jf = JFarm(js, 4, couples=COUPLES, seed=2)
    tf = ReplicaFarm(ts, 4, couples=COUPLES, seed=2)
    e_j = jf.step(0.002, 10, record_dhdl=True)
    e_t = tf.step(0.002, 10, record_dhdl=True)
    assert e_t.shape == (4,) and tf.step_count == 10
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-9, atol=0)
    d_t, d_j = np.asarray(tf.dhdl_trace), np.asarray(jf.dhdl_trace)
    assert d_t.shape == (4, 10) and np.abs(d_j).max() > 0
    assert np.abs(d_t - d_j).max() <= 1e-6 * np.abs(d_j).max()
    wins = tf.windows()
    np.testing.assert_array_equal([w.lam for w in wins],
                                  [w.lam for w in jf.windows()])
    np.testing.assert_allclose([w.lam for w in wins],
                               1.0 - np.asarray(COUPLES), atol=1e-6)


def _fed(farm, noise):
    """Feed a farm the Langevin noise `noise` [steps, R, N, 3], cut per
    chunk, instead of its generator's."""
    it = iter(noise)

    def draws():
        z = next(it)
        return [z[ch.lo:ch.hi] for ch in farm._chunks]
    farm._draws = draws


def test_replicas_are_independent(bath):
    """Each replica of a farm equals an R = 1 farm with the same couple,
    start and noise (gamma 2/ps, so the noise moves them); a farm cut over
    two devices equals one chunk."""
    _, ts = bath
    sim = MdSim(ts.top, ts.cfg.replace(
        integrator=Integrator.langevin_middle(gamma=2.0)),
        ts.state.positions.numpy(), box_extent=ts._box_np,
        velocities=ts.state.velocities.numpy(), method="allpairs_cutoff",
        device="cpu")
    couples = [1.0, 0.5, 0.0]
    g = torch.Generator().manual_seed(11)
    noise = torch.randn((4, 3) + tuple(sim.state.positions.shape),
                        generator=g, dtype=torch.float64)
    farm = ReplicaFarm(sim, 3, couples=couples)
    _fed(farm, noise)
    farm.step(0.002, 4, record_dhdl=True)
    for k, c in enumerate(couples):
        one = ReplicaFarm(sim, 1, couples=[c])
        _fed(one, noise[:, k:k + 1])
        one.step(0.002, 4, record_dhdl=True)
        np.testing.assert_allclose(one.x[0].numpy(), farm.x[k].numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(one.dhdl_trace[0], farm.dhdl_trace[k],
                                   rtol=1e-12, atol=1e-12)
    split = ReplicaFarm(sim, 3, couples=couples, devices=["cpu", "cpu"])
    assert [(ch.lo, ch.hi) for ch in split._chunks] == [(0, 2), (2, 3)]
    _fed(split, noise)
    split.step(0.002, 4, record_dhdl=True)
    np.testing.assert_allclose(split.x.numpy(), farm.x.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(split.dhdl_trace, farm.dhdl_trace,
                               rtol=1e-12, atol=1e-12)


def test_jitter_and_arguments(bath):
    """Jitter moves each replica's integrated atoms by jitter x N(0, 1)
    (statistics only: the draws differ from the reference's); couples
    default to ones; bad arguments raise."""
    _, ts = bath
    jit = 0.05
    farm = ReplicaFarm(ts, 64, seed=4, jitter=jit)
    d = (farm.x - ts.state.positions[None]).numpy()
    dof = ts.top.dof_mask.numpy() > 0
    assert not (d[:, ~dof] != 0).any()
    sd = d[:, dof].std()
    assert abs(sd - jit) < 0.1 * jit and abs(d[:, dof].mean()) < 0.1 * jit
    np.testing.assert_array_equal(farm.couples.numpy(), np.ones(64))
    assert np.array_equal(farm.v.numpy()[3], ts.state.velocities.numpy())
    with pytest.raises(ValueError):
        ReplicaFarm(ts, 2, couples=[1.0])
    with pytest.raises(ValueError):
        ReplicaFarm(ts, 2, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# The cluster and K2 backends on the 1,312-site system
# ---------------------------------------------------------------------------

KW = dict(temp_target=310.0, lj_cutoff=6.0, coulomb_cutoff=6.0,
          max_init_relaxation_iters=None, seed=3, pme_grid=(24, 24, 24))
DT = 0.0005


@pytest.fixture(scope="module")
def solvated():
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    rng = np.random.default_rng(0)
    v0 = rng.normal(size=(asys.topology.n_atoms, 3)) * 2.0 \
        * np.asarray(asys.topology.dof_mask)[:, None]
    return asys, v0


def _cluster_pair(solvated, dtype, **kw):
    """(reference MdSim on clusters, its rebuild fed placed M rows; port
    MdSim), the solute coupled, Langevin-middle at gamma 0."""
    asys, v0 = solvated
    jt, tt = _coupled(*_tops(asys.topology, dtype))
    js = JMd(jt, JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                      hydrogen_constraint=JH.shake(), use_scan_chunks=False,
                      dtype=dtype, **KW),
             np.asarray(asys.positions, dtype), box_extent=asys.box_extent,
             velocities=v0.astype(dtype), method="cells_pme", relax=False)
    rebuild = js._rebuild
    js._rebuild = lambda x, box: rebuild(j_place(x, js.top), box)
    ts = MdSim(tt, MdConfig(integrator=Integrator.langevin_middle(gamma=0.0),
                            hydrogen_constraint=HydrogenConstraint.shake(),
                            dtype=dtype, **KW, **kw),
               asys.positions, box_extent=asys.box_extent, velocities=v0,
               method="cells_pme", relax=False, device="cpu")
    assert js._nbr_backend == "clusters"
    return js, ts


def _farm_run(farm):
    """Two steps, then one recorded step: (x, energies, dH/dlambda)."""
    farm.step(DT, 2)
    e = farm.step(DT, 1, record_dhdl=True)
    return np.asarray(farm.x), np.asarray(e), np.asarray(farm.dhdl_trace)


@pytest.fixture(scope="module")
def cluster_reference(solvated):
    """The reference's cluster farm in float64 (the solute coupled, 2
    replicas at couples [1, 0.5]) over _farm_run, its exclusion
    subtraction differentiated as its kernel's force is
    (tests/jax_reference.py)."""
    with kernel_slope():
        js, _ = _cluster_pair(solvated, "float64")
        return _farm_run(JFarm(js, 2, couples=[1.0, 0.5], seed=2))


def test_farm_matches_the_reference_on_clusters(solvated, cluster_reference):
    _, ts = _cluster_pair(solvated, "float64")
    assert ts._nbr_backend == "clusters"
    tf = ReplicaFarm(ts, 2, couples=[1.0, 0.5], seed=2)
    x_t, e_t, d_t = _farm_run(tf)
    x_j, e_j, d_j = cluster_reference
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-9, atol=0)
    assert d_t.shape == (2, 1) and abs(d_j[1, 0]) > 0
    assert np.abs(d_t - d_j).max() <= 1e-6 * np.abs(d_j).max()
    # a farm step: one rebuild and two forces (f0, the integrator's); the
    # recorded step two energies more
    assert tf.force_evals == 3 * 2 + 2


def test_k2_farm_on_the_cpu(solvated, cluster_reference):
    """The K2 path with a replica axis (the kernel's plain version on the
    CPU): each replica's slice of the batched wrapper equals its
    unbatched plain version exactly, and the K2 farm (float32) follows the
    reference's cluster farm."""
    _, ts = _cluster_pair(solvated, "float32", use_pallas=True)
    assert ts._nbr_backend == "pallas"
    tf = ReplicaFarm(ts, 2, couples=[1.0, 0.5], seed=2)
    x_t, e_t, d_t = _farm_run(tf)
    x_j, e_j, _ = cluster_reference
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=5e-3)
    ch = tf._chunks[0]
    xv = ch.b.place(tf.x)
    (sa, inv, shift), ovf = ch.b.rebuild(xv, ch.box)
    assert int(ovf.max()) == 0
    direct = ts._direct
    center, ghost = direct.inputs(xv, ch.box, sa, shift)
    assert center.shape[0] == ghost.shape[0] == 2
    out = direct.kernel(center, ghost, ch.c, ts._beta)
    for k in range(2):
        c1, g1 = direct.inputs(xv[k], ch.box, sa[k], shift[k])
        assert torch.equal(c1, center[k]) and torch.equal(g1, ghost[k])
        ref = TDF.direct_force_plain(c1, g1, direct.starts, ch.c[k],
                                     ts._beta, direct.rc2,
                                     excl=direct.excl)
        assert torch.equal(out[k], ref)
    f_b, e_lj, e_c, _ = direct(xv, ch.box, ch.c, ts._beta, sa, inv, shift)
    for k in range(2):
        f_1, el1, ec1, _ = direct(xv[k], ch.box, ch.c[k], ts._beta, sa[k],
                                  inv[k], shift[k])
        assert torch.equal(f_b[k], f_1)
        assert float(e_lj[k]) == float(el1) and float(e_c[k]) == float(ec1)
    # energies against the reference's cluster farm, rel 1e-5 of |E| plus
    # the direct space's |e| sums (the excluded solute pairs)
    _, e_scale = reference_scales(ts, tf.x[0])
    tol = 1e-5 * (np.abs(e_j) + sum(e_scale.values()))
    assert (np.abs(e_t - e_j) <= tol).all(), (e_t, e_j, tol)
    assert np.isfinite(d_t).all()


def _single_vs_batched(ts, farm, tol):
    """The farm's batched force and energies against ts.force_fn on each
    replica."""
    ch = farm._chunks[0]
    nbr, _ = ch.b.rebuild(ch.b.place(farm.x), ch.box)
    f_b, (e_b, terms) = ch.b.force(farm.x, ch.box, ch.c, nbr)
    for k in range(farm.n):
        f_1, (e_1, _) = ts.force_fn(farm.x[k], ts.state.box, ch.c[k])
        scale = float(f_1.abs().max())
        assert float((f_b[k] - f_1).abs().max()) <= tol * scale
        assert abs(float(e_b[k]) - float(e_1)) <= tol * abs(float(e_1))
    assert int(terms["cell_overflow"].max()) == 0


@pytest.mark.parametrize("case", ["window", "vacuum", "twin"])
def test_batched_force_matches_single(bath, solvated, case):
    """The backends the other farm tests do not step, in float64: the
    window (the LJ bath on cells_pme; its overflow from the terms),
    allpairs in vacuum (no box), and a chunk's copy of the force paths
    made for another device (here the same CPU) from the MdSim's plan."""
    from molchanica_tpu_torch.parallel.replicas import _twin
    from molchanica_tpu_torch.systems.testmols import build_ethanol

    if case == "vacuum":
        tt, x0 = build_ethanol(dtype=torch.float64)
        ts = MdSim(tt, MdConfig(dtype="float64", seed=3,
                                max_init_relaxation_iters=None), x0,
                   device="cpu")
        assert ts.method == "allpairs"
    elif case == "window":
        b = bath[1]
        ts = MdSim(b.top, b.cfg.replace(direct_backend="window",
                                        pme_grid=(16, 16, 16)),
                   b.state.positions.numpy(), box_extent=b._box_np,
                   method="cells_pme", device="cpu")
        assert ts._nbr_backend == "window"
    else:
        _, ts = _cluster_pair(solvated, "float64")
        assert ts._nbr_backend == "clusters"
    if case == "twin":
        tw = _twin(ts, "cpu")
        assert tw is not ts and tw._plan == ts._plan
        ts_ref, ts = ts, tw
    farm = ReplicaFarm(ts, 2, couples=[1.0, 0.5], seed=5, jitter=0.01)
    _single_vs_batched(ts_ref if case == "twin" else ts, farm, 1e-10)


def test_overflow_raises(solvated):
    """A cluster list too narrow for the system (M = 32) overflows on the
    farm's first rebuild: RuntimeError with the reference's message."""
    _, ts = _cluster_pair(solvated, "float32")
    ts._m_scale = 0.05
    ts.rebuild_neighbor_plan()
    assert ts._plan.m_neighbors == 32
    farm = ReplicaFarm(ts, 2)
    with pytest.raises(RuntimeError, match="ReplicaFarm neighbor overflow"):
        farm.step(DT, 1)


# ---------------------------------------------------------------------------
# MdSim's relaxation in the reference's block structure
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def water13():
    """tests/test_water_sol.py's system in a 13 A box: one LJ bead
    (coupled) in OPC water, in float64 (allpairs_cutoff)."""
    bead = JSpec(masses=np.array([16.0]), charges=np.array([0.0]),
                 lj_sigma=np.array([3.73]), lj_eps=np.array([0.29]),
                 positions=np.zeros((1, 3)))
    box = np.array([13.0] * 3)
    asys = j_assemble([bead.translated(box / 2.0)], box_extent=box,
                      water_model=OPC, alchemical_mol=0, seed=1)
    jt, tt = _tops(asys.topology, "float64")
    return asys, jt, tt


def _relax_cfgs(n):
    kw = dict(lj_cutoff=6.0, coulomb_cutoff=6.0, dtype="float64", seed=1,
              max_init_relaxation_iters=n)
    return (JCfg(hydrogen_constraint=JH.shake(), **kw),
            MdConfig(hydrogen_constraint=HydrogenConstraint.shake(), **kw))


def test_relaxation_takes_the_reference_blocks(water13, monkeypatch):
    """The port's blocks against the reference MdSim's own relaxation: its
    block ends recorded from inside its jitted blocks."""
    asys, jt, tt = water13
    jcfg, tcfg = _relax_cfgs(150)
    ends = []

    def recording(*a, **kw):
        x, e = j_fire(*a, **kw)
        jax.debug.callback(lambda v: ends.append(float(v)), e)
        return x, e
    monkeypatch.setattr(j_minimize, "fire_minimize", recording)
    js = JMd(jt, jcfg, asys.positions, box_extent=asys.box_extent)
    jax.effects_barrier()
    ts = MdSim(tt, tcfg, asys.positions, box_extent=asys.box_extent,
               device="cpu")
    assert ts.method == js.method == "allpairs_cutoff"
    r = ts.relax_log
    assert r["path"] == "blocks" and r["block"] == 100
    assert len(r["block_ends"]) == 2 and r["kept"] == "end"
    assert ts.force_evals == 2 * (100 + 1)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=1e-8)
    assert len(ends) == 2
    np.testing.assert_allclose(r["block_ends"], ends, rtol=1e-9, atol=0)
    e0 = r["e_first"]
    assert ends[0] <= e0 + max(0.01 * abs(e0), 10.0)


def test_relaxation_fallback(water13, monkeypatch):
    """A first block that fails the check: one loop of n iterations from
    the start, the reference's fire_minimize_hostloop, its end kept when
    it passes (40 iterations: one block, then the loop). Where the loop's
    end fails too the engine keeps the lowest state it evaluated
    (tests/test_torch_mdsim_default.py::test_fire_keeps_its_lowest_state
    runs that path)."""
    asys, jt, tt = water13
    jcfg, tcfg = _relax_cfgs(40)
    js = JMd(jt, jcfg.replace(max_init_relaxation_iters=None),
             asys.positions, box_extent=asys.box_extent)
    s = js.state
    x_j, _ = fire_minimize_hostloop(js.force_fn, s.positions, s.box,
                                    s.couple, js.top.dof_mask, n_steps=40,
                                    constrain_positions=js._cp)
    e_j = float(jax.jit(js.force_fn)(x_j, s.box, s.couple)[1][0])
    calls = []

    def first_fails(e0, e):
        calls.append(e)
        return len(calls) > 1
    monkeypatch.setattr(TEng, "relax_check", first_fails)
    ts = MdSim(tt, tcfg, asys.positions, box_extent=asys.box_extent,
               device="cpu")
    r = ts.relax_log
    assert r["path"] == "fallback" and r["kept"] == "end"
    assert len(r["block_ends"]) == 1 and len(calls) == 2
    assert ts.force_evals == 2 * (40 + 1)
    np.testing.assert_allclose(r["e_end"], e_j, rtol=1e-9, atol=0)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(j_place(x_j, js.top)), rtol=0,
                               atol=1e-8)
