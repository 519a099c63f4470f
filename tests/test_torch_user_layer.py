"""Port parity of the MD user layer (molchanica_tpu_torch.md.dynamics,
.checkpoint, .trajectory, .viewer) against molchanica_tpu's, on the CPU.

Systems: test_api.py's vacuum ethanol in float64, ethanol in a fixed
20 A TIP3P cube, four ethanol copies packed into that cube, and (assembly
only) ethanol padded in OPC and in wet octanol. Tolerances:
- MolDynamics.to_spec, add_copies and build_dynamics' assembled system
  (positions, box, every topology array and static, the selected method)
  are host numpy with the same seed: held exactly (np.array_equal).
- The initial force and energy of build_dynamics' MdSim (relaxation off)
  against the JAX MdSim on the same assembled system, its topology cast to
  float64 as the port's is: float64, max|dF| <= 1e-10 max|F| and every
  energy term within 1e-10 of the sum of |terms|.
- read_prmtop's system in MdSim against the JAX MdSim: the same bounds,
  and 10 velocity-Verlet steps from the same velocities within 1e-10 A.
- Checkpoints (no JAX comparison): a run resumed from a file equals the
  uninterrupted run bit for bit (torch.equal), the generator state too.
- Trajectory and SnapshotViewer against the JAX classes on the same
  snapshot arrays: times, frame counts, FrameSlice windows and playback
  exactly; the written files byte for byte; frames read back equal.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.io import open_file as j_open_file
from molchanica_tpu.io.prmtop import read_prmtop as j_read_prmtop
from molchanica_tpu.md import checkpoint as JCk
from molchanica_tpu.md import config as JC
from molchanica_tpu.md import dynamics as JD
from molchanica_tpu.md.engine import MdSim as JMd
from molchanica_tpu.md.engine import select_method as j_select_method
from molchanica_tpu.md.snapshot import Snapshot as JSnap
from molchanica_tpu.md.trajectory import FrameSlice as JFs
from molchanica_tpu.md.trajectory import Trajectory as JTraj
from molchanica_tpu.md.viewer import SnapshotViewer as JViewer
from molchanica_tpu.molecules.spec import MolSpec as JSpec
from molchanica_tpu.molecules.spec import assemble_system as j_assemble
from molchanica_tpu_torch.io import open_file, read_prmtop
from molchanica_tpu_torch.io.gro import read_gro_trajectory
from molchanica_tpu_torch.md import checkpoint as TCk
from molchanica_tpu_torch.md import config as TC
from molchanica_tpu_torch.md import dynamics as TD
from molchanica_tpu_torch.md.engine import MdSim, select_method
from molchanica_tpu_torch.md.snapshot import Snapshot as TSnap
from molchanica_tpu_torch.md.trajectory import FrameSlice, Trajectory
from molchanica_tpu_torch.md.viewer import SnapshotViewer
from molchanica_tpu_torch.molecules.spec import MolSpec as TSpec
from molchanica_tpu_torch.molecules.spec import assemble_system
from molchanica_tpu_torch.topology import STATIC_FIELDS, TENSOR_FIELDS
from test_prmtop import _fixture_text
from test_torch_io import same

torch.set_num_threads(1)

ETHANOL = ["C", "C", "O", "H", "H", "H", "H", "H", "H"]
ETHANOL_POS = np.array([
    [0.0, 0.0, 0.0], [1.53, 0.0, 0.0], [2.0, 1.3, 0.0],
    [-0.4, 1.0, 0.0], [-0.4, -0.5, 0.9], [-0.4, -0.5, -0.9],
    [1.9, -0.5, 0.9], [1.9, -0.5, -0.9], [2.9, 1.3, 0.2]])
REL = 1e-10
SEED = 3
LIGAND = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "molchanica_tpu", "systems", "data", "pocket_ligand.sdf")


def _cfgs(case, **kw):
    """(JAX MdConfig, port MdConfig) of one case, relaxation off."""
    base = dict(temp_target=300.0, dtype="float64",
                max_init_relaxation_iters=None, seed=2, **kw)
    out = []
    for C in (JC, TC):
        if case == "vacuum":       # test_api.py's vacuum_sim, no FIRE
            c = C.MdConfig(
                integrator=C.Integrator.langevin_middle(gamma=2.0),
                hydrogen_constraint=C.HydrogenConstraint.flexible(),
                zero_com_drift=False, **base)
        elif case in ("tip3p", "copies"):
            c = C.MdConfig(sim_box=C.SimBoxInit.new_cube(20.0),
                           solvent=C.Solvent.water_tip3p(), **base)
        elif case == "opc_pad":
            c = C.MdConfig(sim_box=C.SimBoxInit.pad_(6.0),
                           solvent=C.Solvent.water_opc(), **base)
        elif case == "octanol":
            c = C.MdConfig(sim_box=C.SimBoxInit.new_cube(24.0),
                           solvent=C.Solvent.octanol_with_water(), **base)
        out.append(c)
    return out


def _mol(mod, case, **kw):
    n = 4 if case == "copies" else 1
    return mod.MolDynamics(elements=ETHANOL, atom_posits=ETHANOL_POS,
                           n_copies=n, **kw)


def _build(case):
    jc, tc = _cfgs(case)
    js = JD.build_dynamics([_mol(JD, case)], jc, seed=SEED)
    ts = TD.build_dynamics([_mol(TD, case)], tc, seed=SEED, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def built():
    return {case: _build(case) for case in ("vacuum", "tip3p", "copies")}


def _jax_float64(jt):
    """The JAX topology with every float field cast to float64, as the
    port's MdSim casts its own (otherwise the reference forms float32
    products)."""
    fl = {}
    for f in dataclasses.fields(jt):
        v = getattr(jt, f.name)
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
            fl[f.name] = jnp.asarray(np.asarray(v), jnp.float64)
    return jt.replace(**fl)


def _force_parity(js, ts):
    """Force and every energy term of the two MdSims at the JAX state's
    positions, to REL."""
    s = js.state
    fj, (ej, tj) = jax.jit(js.force_fn)(s.positions, s.box, s.couple)
    x = torch.tensor(np.asarray(s.positions))
    ft, (et, tt) = ts.force_fn(x, ts.state.box, ts.state.couple)
    fj = np.asarray(fj)
    assert np.abs(ft.numpy() - fj).max() <= REL * np.abs(fj).max()
    scale = sum(abs(float(tj[k])) for k in ("bond", "angle", "dihedral",
                                           "lj", "coulomb"))
    for k in tj:
        assert abs(float(tt[k]) - float(tj[k])) <= REL * scale, k
    assert abs(float(et) - float(ej)) <= REL * scale


# ---------------------------------------------------------------------------
# MolDynamics, add_copies, build_dynamics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["inferred_bonds", "given_bonds",
                                     "velocities_static", "frcmod", "spec"])
def test_mol_dynamics_to_spec(variant):
    """Every MolSpec field of to_spec under the default parameter set."""
    rng = np.random.default_rng(1)
    pos = ETHANOL_POS + rng.normal(0.0, 0.02, ETHANOL_POS.shape)
    kw = dict(elements=ETHANOL, atom_posits=pos)
    if variant == "given_bonds":
        kw["bonds"] = [(0, 1), (1, 2), (0, 3), (0, 4), (0, 5), (1, 6),
                       (1, 7), (2, 8)]
    elif variant == "velocities_static":
        kw.update(atom_init_velocities=rng.normal(0.0, 1.0, (9, 3)),
                  static_=True, bonded_only=True)
    pj = JD.FfParamSet.new_default()
    pt = TD.FfParamSet.new_default()
    jm, tm = JD.MolDynamics(**kw), TD.MolDynamics(**kw)
    if variant == "frcmod":
        jm.mol_specific_params = pj.small_mol
        tm.mol_specific_params = pt.small_mol
    if variant == "spec":
        masses = rng.uniform(1.0, 16.0, 3)
        common = dict(masses=masses, charges=rng.normal(0.0, 0.3, 3),
                      lj_sigma=np.full(3, 3.4), lj_eps=np.full(3, 0.1),
                      positions=rng.normal(0.0, 2.0, (3, 3)),
                      bonds=[(0, 1, 300.0, 1.5)])
        jm = JD.MolDynamics(spec=JSpec(**common), bonded_only=True)
        tm = TD.MolDynamics(spec=TSpec(**common), bonded_only=True)
    same(tm.to_spec(pt), jm.to_spec(pj), "MolSpec")


@pytest.mark.parametrize("n,seed", [(8, 1), (5, 4), (27, 0)])
def test_add_copies(n, seed):
    """The same positions bit for bit, with and without existing atoms."""
    rng = np.random.default_rng(seed)
    common = dict(masses=np.full(3, 12.0), charges=np.zeros(3),
                  lj_sigma=np.full(3, 3.4), lj_eps=np.full(3, 0.1),
                  positions=rng.normal(0.0, 1.2, (3, 3)))
    box = np.array([24.0, 26.0, 25.0])
    existing = rng.uniform(0.0, 24.0, (20, 3))
    for ex in (None, existing):
        jc = JD.add_copies(JSpec(**common), n, box, existing=ex, seed=seed)
        tc = TD.add_copies(TSpec(**common), n, box, existing=ex, seed=seed)
        assert len(tc) == len(jc) == n
        for a, b in zip(jc, tc):
            assert np.array_equal(a.positions, b.positions)


def _assembled_equal(js, ts):
    ja, ta = js.assembled, ts.assembled
    assert np.array_equal(ja.positions, ta.positions)
    assert (ja.box_extent is None) == (ta.box_extent is None)
    if ja.box_extent is not None:
        assert np.array_equal(np.asarray(ja.box_extent),
                              np.asarray(ta.box_extent))
    assert ja.mol_start_indices == ta.mol_start_indices
    assert (ja.n_solute_atoms, ja.n_waters) == (ta.n_solute_atoms,
                                                ta.n_waters)
    jt, tt = ja.topology, ta.topology
    for f in TENSOR_FIELDS:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f
        assert np.issubdtype(a.dtype, np.floating) == \
            np.issubdtype(b.dtype, np.floating), f
        if np.issubdtype(a.dtype, np.floating):
            assert a.dtype == b.dtype, f
    for f in STATIC_FIELDS:
        assert getattr(jt, f) == getattr(tt, f), f


@pytest.mark.parametrize("case", ["vacuum", "tip3p", "copies"])
def test_build_dynamics_system(built, case):
    """The assembled system bit for bit, the selected method and the
    initial positions of the state."""
    js, ts = built[case]
    _assembled_equal(js, ts)
    assert ts.method == js.method == {"vacuum": "allpairs"}.get(
        case, "allpairs_cutoff")
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["vacuum", "tip3p", "copies"])
def test_build_dynamics_initial_force(built, case):
    """build_dynamics' MdSim against the JAX MdSim on the same assembled
    system (its topology in float64), relaxation off."""
    js, ts = built[case]
    jc, _ = _cfgs(case)
    ja = js.assembled
    ref = JMd(_jax_float64(ja.topology), jc, ja.positions,
              box_extent=ja.box_extent, relax=False)
    assert ref.method == ts.method
    _force_parity(ref, ts)


def _no_engine(select_method):
    """Stands in for MdSim where only the assembly and the method that
    MdSim would select are compared."""
    class NoEngine:
        def __init__(self, top, cfg, x0, box_extent=None, **kw):
            self.method = select_method(box_extent, np.asarray(x0).shape[0],
                                        cfg)
    return NoEngine


def _ligand(mod, open_file):
    """The committed ligand (ibuprofen) through each package's open_file,
    as the README's quick start reads it."""
    mol = open_file(LIGAND)
    return mod.MolDynamics(elements=mol.elements, atom_posits=mol.positions,
                           bonds=mol.bonds)


@pytest.mark.parametrize("case,method", [
    ("opc_pad", "allpairs_cutoff"), ("octanol", "allpairs_cutoff"),
    ("quickstart_pad10", "allpairs_cutoff"),
    ("quickstart_pad11", "cells_pme")])
def test_build_dynamics_solvent_branches(case, method):
    """The padded OPC box, wet octanol and the README's quick start on the
    committed ligand (its pad of 10 A: 1,973 sites, under the 2,048 of
    select_method; 11 A: 2,289) assemble bit for bit, and both packages
    select the same method on them (the engine is not built). The quick
    start runs at build_dynamics' default seed, as the README's does."""
    seed = SEED
    if case.startswith("quickstart"):
        seed = 0
        pad = float(case[-2:])
        jc, tc = (C.MdConfig(integrator=C.Integrator.langevin_middle(
            gamma=1.0), temp_target=310.0, solvent=C.Solvent.water_opc(),
            sim_box=C.SimBoxInit.pad_(pad)) for C in (JC, TC))
        jm, tm = _ligand(JD, j_open_file), _ligand(TD, open_file)
    else:
        jc, tc = _cfgs(case)
        jm, tm = _mol(JD, case), _mol(TD, case)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "MdSim", _no_engine(j_select_method))
        mp.setattr(TD, "MdSim", _no_engine(select_method))
        js = JD.build_dynamics([jm], jc, seed=seed)
        ts = TD.build_dynamics([tm], tc, seed=seed, device="cpu")
    _assembled_equal(js, ts)
    assert ts.assembled.n_waters > 0
    assert ts.method == js.method == method
    if case == "quickstart_pad10":
        assert ts.assembled.topology.n_atoms_real == 1973


def test_build_dynamics_no_fallback():
    """A use_pallas config that the K2 path cannot take (float64 on
    cells_pme) raises, as MdSim does; copies need a fixed box."""
    _, tc = _cfgs("tip3p")
    tc = tc.replace(sim_box=TC.SimBoxInit.new_cube(30.0), use_pallas=True)
    with pytest.raises(NotImplementedError, match="float32 only"):
        TD.build_dynamics([_mol(TD, "tip3p")], tc, seed=SEED, device="cpu")
    _, tv = _cfgs("vacuum")
    with pytest.raises(ValueError, match="fixed sim box"):
        TD.build_dynamics([_mol(TD, "copies")], tv, device="cpu")


def test_build_dynamics_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tc = _cfgs("vacuum")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.build_dynamics([_mol(TD, "vacuum")], tc)


def test_prmtop_system_in_mdsim(tmp_path):
    """read_prmtop's MolSpec, assembled and run in MdSim (allpairs,
    float64), against the JAX MdSim: force and energy terms, then 10
    velocity-Verlet steps from the same velocities."""
    p = tmp_path / "t.prmtop"
    p.write_text(_fixture_text())
    x = np.array([[0.0, 0, 0], [1.53, 0, 0], [-0.5, 0.9, 0], [2.0, -0.9, 0]])
    jspec, tspec = j_read_prmtop(str(p), coords=x), read_prmtop(
        str(p), coords=x)
    ja, ta = j_assemble([jspec]), assemble_system([tspec])
    assert np.array_equal(ja.positions, ta.positions)
    v0 = np.random.default_rng(5).normal(0.0, 2.0, ja.positions.shape) \
        * np.asarray(ja.topology.dof_mask)[:, None]
    kw = dict(temp_target=300.0, dtype="float64", seed=1,
              max_init_relaxation_iters=None)
    js = JMd(_jax_float64(ja.topology), JC.MdConfig(
        integrator=JC.Integrator.verlet_velocity(thermostat=None),
        use_scan_chunks=False, **kw), ja.positions, velocities=v0)
    ts = MdSim(ta.topology, TC.MdConfig(
        integrator=TC.Integrator.verlet_velocity(thermostat=None), **kw),
        ta.positions, velocities=v0, device="cpu")
    assert ts.method == js.method == "allpairs"
    _force_parity(js, ts)
    js.step(0.001, 10)
    ts.step(0.001, 10)
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               np.asarray(js.state.positions), rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state_equal(a, b):
    for f in ("positions", "velocities", "couple", "pe_last", "ke_last",
              "dhdl_last"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.box is None) == (b.box is None)
    if a.box is not None:
        assert torch.equal(a.box, b.box)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("case", ["vacuum", "tip3p"])
def test_checkpoint_resumes_bit_for_bit(case, tmp_path):
    """Langevin (vacuum) and velocity-Verlet + CSVR (the TIP3P box): a
    fresh MdSim loaded from the file continues exactly as the run that
    wrote it; the restored state equals the saved one bit for bit."""
    _, tc = _cfgs(case)

    def fresh():
        return TD.build_dynamics([_mol(TD, case)], tc, seed=SEED,
                                 device="cpu")

    a = fresh()
    a.step(0.001, 6)
    p = tmp_path / "ck.npz"
    TCk.save_checkpoint(p, a, extra={"note": "test"})
    saved = a.state.replace(generator=torch.Generator().set_state(
        a.state.generator.get_state()))
    a.step(0.001, 6)
    b = fresh()
    b.step(0.001, 2)                 # a different state and stream
    TCk.load_checkpoint(p, b)
    _state_equal(b.state, saved)
    assert b.state.generator is not saved.generator
    b.step(0.001, 6)
    _state_equal(b.state, a.state)
    assert b.step_count == 12


def test_checkpoint_refuses_jax_file_and_unknown_version(built, tmp_path):
    """A file the JAX package wrote (an rng_key, no generator state) is
    refused, not reseeded; so is an unknown format version."""
    js, ts = built["vacuum"]
    pj = tmp_path / "jax.npz"
    JCk.save_checkpoint(pj, js)
    with pytest.raises(ValueError, match="written by the JAX package"):
        TCk.load_checkpoint(pj, ts)
    pt = tmp_path / "port.npz"
    TCk.save_checkpoint(pt, ts)
    z = dict(np.load(pt))
    meta = json.loads(str(z["meta"]))
    meta["version"] = 99
    z["meta"] = json.dumps(meta)
    pv = tmp_path / "v99.npz"
    np.savez(pv, **z)
    with pytest.raises(ValueError, match="version 99"):
        TCk.load_checkpoint(pv, ts)


# ---------------------------------------------------------------------------
# Trajectory and SnapshotViewer
# ---------------------------------------------------------------------------

def _snaps(Snap, n=6, n_solute=7, n_w=5, seed=11):
    """Snapshots at 0.05 ps spacing with solute and water rows and a box."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        w = rng.uniform(0.0, 18.0, (3, n_w, 3))
        out.append(Snap(time=0.05 * k,
                        atom_posits=rng.uniform(0.0, 18.0, (n_solute, 3)),
                        water_o_posits=w[0], water_h0_posits=w[1],
                        water_h1_posits=w[2],
                        box_extent=np.array([18.0, 19.0, 20.0])))
    return out


SLICES = [dict(), dict(start=1), dict(start=1, stop=5, step=2),
          dict(stop=-1), dict(t_start=0.1), dict(t_start=0.06, t_stop=0.2),
          dict(t_stop=0.1, step=2), dict(start=-2)]


def _ids(snaps):
    return [round(s.time / 0.05) for s in snaps]


def test_trajectory_in_memory():
    jt = JTraj.from_memory(_snaps(JSnap))
    tt = Trajectory.from_memory(_snaps(TSnap))
    assert tt.n_frames == jt.n_frames == 6
    assert np.array_equal(tt.times(), jt.times())
    for kw in SLICES:
        assert _ids(tt.load_snaps(FrameSlice(**kw))) == \
            _ids(jt.load_snaps(JFs(**kw))), kw
        assert np.array_equal(FrameSlice(**kw).select(tt.times()),
                              JFs(**kw).select(jt.times()))


@pytest.mark.parametrize("fmt", ["dcd", "trr", "xtc", "gro"])
def test_trajectory_files(fmt, tmp_path):
    """save_<fmt> writes the JAX package's bytes (water M sites dropped, as
    _frame_coords does); the file reopens with the same frames, times and
    boxes in both packages' Trajectory, windowed by FrameSlice. A .gro
    opens for its frame count only and load_snaps refuses it, in both;
    its frames, read by io.gro.read_gro_trajectory, are held to the
    format's 3 decimals in nm."""
    jt = JTraj.from_memory(_snaps(JSnap))
    tt = Trajectory.from_memory(_snaps(TSnap))
    pj, pt = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    if fmt == "gro":
        els = ["C"] * 7 + ["O", "H", "H"] * 5
        jt.save_gro(pj, els)
        tt.save_gro(pt, els)
    else:
        getattr(jt, f"save_{fmt}")(pj)
        getattr(tt, f"save_{fmt}")(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    t2 = Trajectory.open(pt)
    assert t2.n_frames == JTraj.open(pj).n_frames == 6
    want = np.stack([Trajectory._frame_coords(s) for s in tt.snapshots])
    if fmt == "gro":
        with pytest.raises(ValueError):
            JTraj.open(pj).load_snaps(JFs(start=1))
        with pytest.raises(ValueError):
            t2.load_snaps(FrameSlice(start=1))
        got, boxes = read_gro_trajectory(pt)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 + 1e-9)
        np.testing.assert_allclose(boxes, [[18.0, 19.0, 20.0]] * 6,
                                   rtol=0, atol=5e-5)
        return
    j2 = JTraj.open(pj)
    assert np.array_equal(t2.times(), j2.times())
    for kw in SLICES:
        a, b = t2.load_snaps(FrameSlice(**kw)), j2.load_snaps(JFs(**kw))
        assert len(a) == len(b), kw
        for x, y in zip(a, b):
            assert x.time == y.time
            assert np.array_equal(x.atom_posits, y.atom_posits)
            same(x.box_extent, y.box_extent, "box")


def test_snapshot_viewer():
    """Playback (tick's advance and wrap, pause), frame_at_time and the
    DCD load, step for step against the JAX viewer."""
    jv, tv = JViewer(), SnapshotViewer()
    jv.load_snapshots(_snaps(JSnap, n=10))
    tv.load_snapshots(_snaps(TSnap, n=10))
    assert tv.current_snapshot == jv.current_snapshot == 0
    tv.change_snapshot(4)
    jv.change_snapshot(4)
    assert tv.get_active_snap().time == jv.get_active_snap().time
    with pytest.raises(IndexError):
        tv.change_snapshot(10)
    tv.playback_ratio = jv.playback_ratio = 10.0
    tv.play()
    jv.play()
    for dt in (0.05, 0.06, 1.0, 0.33, 0.0, 2.71, 0.09):
        assert tv.tick(dt) == jv.tick(dt), dt
        assert tv.current_snapshot == jv.current_snapshot
    tv.pause()
    jv.pause()
    assert tv.tick(5.0) is None and jv.tick(5.0) is None
    for t in (-1.0, 0.0, 0.12, 0.125, 0.26, 0.449, 9.0):
        assert tv.frame_at_time(t) == jv.frame_at_time(t), t


def test_snapshot_viewer_load_trajectory(tmp_path):
    p = str(tmp_path / "t.dcd")
    Trajectory.from_memory(_snaps(TSnap)).save_dcd(p)
    tv = SnapshotViewer().load_trajectory(p, FrameSlice(start=2),
                                          dt_ps=0.05)
    jv = JViewer().load_trajectory(p, JFs(start=2), dt_ps=0.05)
    assert len(tv.snapshots) == len(jv.snapshots) == 4
    for a, b in zip(tv.snapshots, jv.snapshots):
        assert a.time == b.time
        assert np.array_equal(a.atom_posits, b.atom_posits)
    assert tv.frame_at_time(0.21) == jv.frame_at_time(0.21)
    assert tv.get_active_snap().time == jv.get_active_snap().time


def test_launch_md_join_raises_the_runs_error():
    """launch_md runs sim.run on a thread; join returns the snapshots, or
    raises the error the run raised."""
    _, tc = _cfgs("vacuum")
    ts = TD.build_dynamics([_mol(TD, "vacuum")], tc, seed=SEED,
                           device="cpu")
    n0, s0 = ts.step_count, len(ts.snapshots)
    h = TD.launch_md(ts, 0.001, 20, 10)
    assert len(h.join(timeout=120)) == s0 + 2
    assert not h.running and ts.step_count == n0 + 20

    class Broken(RuntimeError):
        pass

    def fail(*a, **k):
        raise Broken("step failed")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "run", fail)
        h = TD.launch_md(ts, 0.001, 20, 10)
        with pytest.raises(Broken, match="step failed"):
            h.join(timeout=120)
    assert not h.running


@pytest.mark.slow
@pytest.mark.parametrize("pad,n_steps,method", [
    (10.0, 60, "allpairs_cutoff"), (11.0, 100, "cells_pme")])
def test_reference_quick_start_heats(pad, n_steps, method):
    """The witness for chip_smoke.py's phase N, which pads 11 A and runs
    400 steps: the JAX package's own README quick start (Langevin-middle at
    gamma 1/ps and 310 K in OPC, FIRE 200 at construction, float32, seed
    0) on the committed ligand. At the README's pad of 10 A (1,973 sites,
    allpairs_cutoff: Coulomb cut at 9 A, no PME) FIRE ends far above the
    energy of the same build without FIRE, and within 60 steps of 2 fs T
    is past 600 K. At 11 A (cells_pme) the fresh water fill is still above 600 K
    at step 100. Prints the energies and T every 10 steps."""
    cfg = JC.MdConfig(integrator=JC.Integrator.langevin_middle(gamma=1.0),
                      temp_target=310.0, solvent=JC.Solvent.water_opc(),
                      sim_box=JC.SimBoxInit.pad_(pad))
    e0 = JD.build_dynamics([_ligand(JD, j_open_file)], dataclasses.replace(
        cfg, max_init_relaxation_iters=None)).potential_energy()
    sim = JD.build_dynamics([_ligand(JD, j_open_file)], cfg)
    assert sim.method == method
    e1 = sim.potential_energy()
    temps = []
    for _ in range(n_steps // 10):
        sim.step(0.002, 10)
        temps.append(float(sim.temperature()))
    print(f"reference quick start at a pad of {pad:g} A: "
          f"{sim.assembled.topology.n_atoms_real} sites, {sim.method}; "
          f"E {e0:.3f} built without FIRE, {e1:.3f} after it; T every 10 "
          "steps: " + ", ".join(f"{t:.2f}" for t in temps) + " K")
    assert np.isfinite(np.asarray(sim.state.positions)).all()
    if pad == 10.0:
        assert e1 > e0 + 0.5 * abs(e0)
    assert temps[-1] > 600.0
