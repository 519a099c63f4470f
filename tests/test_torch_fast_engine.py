"""Port parity: FastSim at init (molchanica_tpu_torch.md.fast_engine) against
molchanica_tpu.md.fast_engine on the CPU, on the solvated 8-residue
polyalanine in a 24 A OPC box at a 6 A cutoff (1,312 sites, S = 1,920).
Both engines start from the same positions and velocities; the reference
runs its Pallas kernels in interpret mode.

Tolerances: sorted layout, ownership and split tables exactly equal;
constraint projections within 1e-5 A (A/ps); energy terms rel < 1e-5,
except the reciprocal term at 3e-5 (the reference's float32 mesh-energy
reduction alone is off by ~1e-5 of the float64 value); forces within
1e-4 of the largest force plus 2e-6 of the largest direct-space kernel
force. The second part is float32 roundoff: excluded solute pairs enter
the kernel sums at ~1e5 kcal/mol/A and are subtracted again, so their
cancellation leaves order-1e-6-relative residues that the two summation
orders do not share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.fast_engine import FastSim as JFast
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.fast_engine import FastSim
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)

torch.set_num_threads(1)

KW = dict(temp_target=310.0, lj_cutoff=6.0, coulomb_cutoff=6.0,
          dtype="float32", max_init_relaxation_iters=None, seed=3,
          neighbor_rebuild_every=4)


def _system():
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    rng = np.random.default_rng(0)
    v0 = (rng.normal(size=(asys.topology.n_atoms, 3)) * 2.0
          * np.asarray(asys.topology.dof_mask)[:, None]).astype(np.float32)
    return asys, v0


def make_port(gamma=0.0):
    """The port's FastSim on the test system (CPU)."""
    asys, v0 = _system()
    jt = asys.topology
    tt = topology_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS},
        {s: getattr(jt, s) for s in STATIC_FIELDS})
    return FastSim(tt, MdConfig(
        integrator=Integrator.langevin_middle(gamma=gamma),
        hydrogen_constraint=HydrogenConstraint.shake(), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0,
        device="cpu")


def make_pair(gamma=0.0):
    """(reference FastSim, port FastSim) on one system and velocities."""
    asys, v0 = _system()
    js = JFast(asys.topology,
               JCfg(integrator=JInt.langevin_middle(gamma=gamma),
                    hydrogen_constraint=JH.shake(), **KW),
               asys.positions, box_extent=asys.box_extent, velocities=v0)
    return js, make_port(gamma)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _eq(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                  err_msg=name)


def test_plan_and_sizes(pair):
    js, ts = pair
    assert ts.S == js.S == 1920
    for f in ("nx", "ny", "n_sorted", "skin", "beta", "erfcx_coeffs",
              "kpoly_coeffs", "r_blob", "offsets"):
        assert getattr(ts.plan, f) == getattr(js.plan, f), f
    for k in ("S_L", "S_Q"):
        assert ts._split[k] == js._split[k], k
    assert ts._recip.K == tuple(js.cfg.pme_grid or ts._recip.K)
    assert ts.n_constraints == js.n_constraints


@pytest.mark.parametrize("field", [
    "perm", "props", "masses", "dof", "w_of", "w_role", "vm_of", "hc_of",
    "hc_role", "hc_idx", "overflow"])
def test_sorted_state_equal(pair, field):
    js, ts = pair
    _eq(getattr(js.state, field), getattr(ts.state, field), field)


@pytest.mark.parametrize("field", [
    "bond_idx", "angle_idx", "dihedral_idx", "excl_idx", "p14_idx"])
def test_gather_indices_equal(pair, field):
    """The port clamps pad slots S to S - 1, as the reference's gathers
    do implicitly."""
    js, ts = pair
    ref = np.minimum(np.asarray(getattr(js.state, field)), js.S - 1)
    _eq(ref, getattr(ts.state, field), field)


@pytest.mark.parametrize("key", [
    "idx_l", "idx_q", "props_l", "props_q", "wl_l", "nw_l", "wl_q", "nw_q",
    "gsrc_l", "gsrc_q"])
def test_split_tables_equal(pair, key):
    js, ts = pair
    _eq(js.state.split[key], ts.state.split[key], key)


def test_init_projection_and_velocities(pair):
    js, ts = pair
    np.testing.assert_allclose(ts.state.x.numpy(), np.asarray(js.state.x),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.state.v.numpy(),
                                  np.asarray(js.state.v))


def _port_state_at(ts, x):
    return ts.state.replace(x=torch.tensor(np.asarray(x)))


def test_init_force_and_energy_terms(pair):
    js, ts = pair
    st = js.state
    force_j = js._make_force_fn(None, want_energy=True)
    fj, (ej, tj) = jax.jit(lambda x, s: force_j(x, s))(st.x, st)
    tst = _port_state_at(ts, st.x)
    with torch.no_grad():
        ft, (et, tt) = ts._make_force_fn(True)(tst.x, tst)
        sp = tst.split
        x_ext = torch.cat([tst.x, torch.full((1, 3), 1e6)])
        rows = torch.cat([x_ext[sp["idx_l"]], sp["props_l"]], 1)
        f_dir, _, _ = ts._split["kernels"][False]["L"](
            rows, rows.T.contiguous(), sp["wl_l"], sp["nw_l"], tst.box,
            tst.couple)
    for k, ref in tj.items():
        ref = float(np.float32(ref))
        if k in ("energy_potential", "energy_potential_nonbonded"):
            # sums of terms that cancel: held through the terms
            continue
        tol = 3e-5 if k == "recip" else 1e-5
        assert abs(float(tt[k]) - ref) <= tol * abs(ref), k
    fj = np.asarray(fj, np.float32)
    err = np.abs(ft.numpy() - fj).max()
    assert err <= 1e-4 * np.abs(fj).max() + 2e-6 * float(f_dir.abs().max())
    assert np.abs(fj).max() > 10.0


def test_potential_energy(pair):
    js, ts = pair
    e_ref = float(np.float32(js.potential_energy()))
    e = ts.potential_energy()
    scale = abs(float(ts._last_terms["lj"]))
    assert abs(e - e_ref) <= 1e-5 * max(abs(e_ref), scale)


def test_constraint_projections(pair):
    """Rolled SETTLE + star M-SHAKE positions, RATTLE velocities."""
    js, ts = pair
    st = js.state
    cp_j, cv_j = js._make_cp_cv()
    cp_t, cv_t = ts._make_cp_cv()
    rng = np.random.default_rng(7)
    x = np.asarray(st.x)
    dx = rng.normal(0, 0.02, x.shape).astype(np.float32)
    dx[np.asarray(st.props)[:, 4] == 0] = 0.0
    x_new = x + dx
    v = rng.normal(0, 3.0, x.shape).astype(np.float32)
    ref_x = np.asarray(jax.jit(lambda a, b, s: cp_j(a, b, s))(
        jnp.asarray(x_new), st.x, st))
    ref_v = np.asarray(jax.jit(lambda a, b, s: cv_j(a, b, s))(
        jnp.asarray(v), st.x, st))
    tst = _port_state_at(ts, x)
    got_x = cp_t(torch.tensor(x_new), tst.x, tst).numpy()
    got_v = cv_t(torch.tensor(v), tst.x, tst).numpy()
    np.testing.assert_allclose(got_x, ref_x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_v, ref_v, rtol=0, atol=1e-5)
    assert np.abs(got_x - x_new).max() > 1e-3     # the projection acted

