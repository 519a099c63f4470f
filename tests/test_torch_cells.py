"""Port parity: the cell-binned shift window (molchanica_tpu_torch.ops.cells)
against molchanica_tpu.ops.cells: plan_cells, bin_atoms, the "window"
direct force of MdSim and the "cells_pme" direct-space energy, and
compute_energy_snapshot on it.

Inputs: tests/test_clusters.py's 700 random sites (26 x 24 x 28 A box,
ten sites whole boxes outside it, 8 A cutoff) for the window force, and
the solvated 8-residue polyalanine in a 24 A OPC box (1,312 sites, 6 A
cutoff, exclusions and 1-4 pairs) for the energy. Tolerances: plans and
binnings equal; window forces within 1e-6 (float64) / 1e-5 (float32) of
max|F|, energies rel 1e-6 / 1e-5; the cells_pme energy, its gradient and
compute_energy_snapshot's terms in float64 within 1e-9 relative (of
max|grad| for the gradient); in float32 no further from the float64
reference than twice the reference's own float32 result, or rel 1e-5
(the LJ total carries excluded pairs clipped at 1e7 kcal/mol that are
subtracted again, the Coulomb total ~1e5 kcal/mol of self energy and
exclusion correction).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.config import MdOverrides as JOv
from molchanica_tpu.md.engine import compute_energy_snapshot as j_snapshot
from molchanica_tpu.ops import cells as JC
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu.topology import make_topology as j_make_topology
from molchanica_tpu_torch.md.config import MdConfig, MdOverrides
from molchanica_tpu_torch.md.engine import compute_energy_snapshot
from molchanica_tpu_torch.ops import cells as TC
from molchanica_tpu_torch.ops.exclusions import exclusion_table
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           make_topology,
                                           topology_from_numpy)

torch.set_num_threads(1)

DTYPES = {"float64": (torch.float64, jnp.float64, 1e-6),
          "float32": (torch.float32, jnp.float32, 1e-5)}
BETA = 0.35


@pytest.fixture(scope="module")
def random_box():
    rng = np.random.default_rng(5)
    box = np.array([26.0, 24.0, 28.0])
    n, npad = 700, 768
    pos = rng.uniform(0, 1, (n, 3)) * box
    q = rng.normal(size=n) * 0.3
    q -= q.mean()
    sig = rng.uniform(2.5, 3.5, n)
    eps = rng.uniform(0.05, 0.3, n)
    x = np.full((npad, 3), 1e6)
    x[:n] = pos
    x[:10] += box * np.array([2.0, -1.0, 0.0])
    tops = {name: (j_make_topology(np.ones(n) * 12, q, sig, eps,
                                   pad_atoms_to=npad, dtype=jdt),
                   make_topology(np.ones(n) * 12, q, sig, eps,
                                 pad_atoms_to=npad, dtype=tdt))
            for name, (tdt, jdt, _) in DTYPES.items()}
    return tops, x, box


@pytest.fixture(scope="module")
def solvated():
    """(system, {dtype: (reference topology, port topology)}): the
    reference's float64 twin casts every float field, so that neither side
    forms products of float32 properties."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    jt = asys.topology
    fields = {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS}
    statics = {s: getattr(jt, s) for s in STATIC_FIELDS}
    jt64 = jt.replace(**{f: jnp.asarray(a, jnp.float64)
                         for f, a in fields.items()
                         if np.issubdtype(a.dtype, np.floating)})
    return asys, {
        name: (jt64 if name == "float64" else jt,
               topology_from_numpy(fields, statics, dtype=tdt))
        for name, (tdt, _, _) in DTYPES.items()}


@pytest.mark.parametrize("box,cutoff,with_x0", [
    ((24.0, 24.0, 24.0), 6.0, True), ((59.7878,) * 3, 9.0, False),
    ((14.0, 15.0, 16.0), 6.0, False), ((26.0, 24.0, 28.0), 8.0, True)])
def test_plan_cells(box, cutoff, with_x0):
    rng = np.random.default_rng(3)
    x0 = rng.uniform(0, 1, (900, 3)) * np.asarray(box) if with_x0 else None
    ref = JC.plan_cells(np.asarray(box), cutoff, 900, 1.7, x0=x0)
    got = TC.plan_cells(np.asarray(box), cutoff, 900, 1.7, x0=x0)
    assert got[:2] == ref[:2]
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("capacity", [None, 4])
def test_bin_atoms(random_box, name, capacity):
    tops, x, box = random_box
    tdt, jdt, _ = DTYPES[name]
    jt, tt = tops[name]
    nc, cap, _ = JC.plan_cells(box, 8.0, 700, 1.7, x0=x)
    cap = capacity or cap
    g_j, ovf_j = jax.jit(lambda x_: JC.bin_atoms(
        x_, jnp.asarray(box, jdt), jt.atom_mask, nc, cap))(
        jnp.asarray(x, jdt))
    g_t, ovf_t = TC.bin_atoms(torch.tensor(x, dtype=tdt),
                              torch.tensor(box, dtype=tdt), tt.atom_mask,
                              nc, cap)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert int(ovf_t) == int(ovf_j)
    assert (int(ovf_t) > 0) == (capacity is not None)


@pytest.mark.parametrize("name", list(DTYPES))
def test_window_direct_force(random_box, name):
    tops, x, box = random_box
    tdt, jdt, tol = DTYPES[name]
    jt, tt = tops[name]
    win_j = JC.make_xla_direct_force_fn(
        jt, JCfg(lj_cutoff=8.0, coulomb_cutoff=8.0, dtype=name), box, x0=x)
    win_t = TC.make_xla_direct_force_fn(
        tt, MdConfig(lj_cutoff=8.0, coulomb_cutoff=8.0, dtype=name), box,
        x0=x, excl=exclusion_table(tt))
    f_j, elj_j, ec_j, ovf_j = jax.jit(lambda x_: win_j(
        x_, jnp.asarray(box, jdt), jnp.asarray(1.0, jdt), BETA))(
        jnp.asarray(x, jdt))
    xt = torch.tensor(x, dtype=tdt)
    bt = torch.tensor(box, dtype=tdt)
    one = torch.tensor(1.0, dtype=tdt)
    f_t, elj_t, ec_t, ovf_t = win_t(xt, bt, one, BETA)
    f_j = np.asarray(f_j)
    assert int(ovf_t) == int(ovf_j) == 0
    assert np.abs(f_t.numpy() - f_j).max() <= tol * np.abs(f_j).max()
    assert abs(float(elj_t) - float(elj_j)) <= tol * abs(float(elj_j))
    assert abs(float(ec_t) - float(ec_j)) <= tol * abs(float(ec_j))
    # under autograd (checkpointed per shift) the energies are the same
    # and, in float64, their gradient is the analytic force
    xg = xt.clone().requires_grad_(True)
    none, elj_g, ec_g, _ = win_t(xg, bt, one, BETA, want_force=False)
    assert none is None
    assert float(elj_g.detach()) == float(elj_t)
    assert float(ec_g.detach()) == float(ec_t)
    if name == "float64":
        (g,) = torch.autograd.grad(elj_g + ec_g, xg)
        assert float((g + f_t).abs().max()) <= 1e-9 * float(
            f_t.abs().max())


def _near_f64(got, ref32, ref64, rtol=1e-5):
    """A float32 result is held to the float64 reference: no further from
    it than twice the reference's own float32 result is, or rtol."""
    return abs(got - ref64) <= max(2.0 * abs(ref32 - ref64),
                                   rtol * abs(ref64), 1e-6)


def _cell_energy(tops, asys, name):
    """((el, ec) of the reference, (el, ec, grad) of the port) in `name`."""
    tdt, jdt, _ = DTYPES[name]
    jt, tt = tops[name]
    box = np.asarray(asys.box_extent, np.float64)
    x = np.asarray(asys.positions, np.float64)
    d_j = JC.make_cell_direct_space_fn(
        jt, JCfg(lj_cutoff=6.0, coulomb_cutoff=6.0, dtype=name), box, x0=x)
    d_t = TC.make_cell_direct_space_fn(
        tt, MdConfig(lj_cutoff=6.0, coulomb_cutoff=6.0, dtype=name), box,
        x0=x, excl=exclusion_table(tt))
    bj = jnp.asarray(box, jdt)
    one_j = jnp.asarray(1.0, jdt)
    el_j, ec_j, ovf_j = jax.jit(lambda x_: d_j(x_, bj, one_j, BETA))(
        jnp.asarray(x, jdt))
    g_j = jax.jit(jax.grad(lambda x_: sum(d_j(x_, bj, one_j, BETA)[:2])))(
        jnp.asarray(x, jdt))
    xt = torch.tensor(x, dtype=tdt).requires_grad_(True)
    el_t, ec_t, ovf_t = d_t(xt, torch.tensor(box, dtype=tdt),
                            torch.tensor(1.0, dtype=tdt), BETA)
    (g_t,) = torch.autograd.grad(el_t + ec_t, xt)
    assert int(ovf_t) == int(ovf_j) == 0
    return ((float(el_j), float(ec_j), np.asarray(g_j)),
            (float(el_t.detach()), float(ec_t.detach()), g_t.numpy()))


def test_cell_direct_space_energy(solvated):
    """float64: energies rel 1e-9 and the gradient within 1e-9 of
    max|grad|; float32: energies no further from the float64 reference
    than twice the reference's float32 result (or rel 1e-5)."""
    asys, tops = solvated
    ref64, got64 = _cell_energy(tops, asys, "float64")
    ref32, got32 = _cell_energy(tops, asys, "float32")
    for k in (0, 1):
        assert abs(got64[k] - ref64[k]) <= 1e-9 * abs(ref64[k])
        assert _near_f64(got32[k], ref32[k], ref64[k])
    g = ref64[2]
    assert np.abs(got64[2] - g).max() <= 1e-9 * np.abs(g).max()


def _snapshots(asys, tops, ov, name):
    kw = dict(lj_cutoff=6.0, coulomb_cutoff=6.0, pme_grid=(24, 24, 24),
              dtype=name)
    jt, tt = tops[name]
    ref = j_snapshot(jt, JCfg(overrides=JOv(**ov), **kw),
                     np.asarray(asys.positions), asys.box_extent,
                     method="cells_pme")
    got = compute_energy_snapshot(tt, MdConfig(overrides=MdOverrides(**ov),
                                               **kw),
                                  np.asarray(asys.positions),
                                  asys.box_extent, method="cells_pme",
                                  device="cpu")
    return ref, got


@pytest.mark.parametrize("ablation", ["none", "lj_disabled",
                                      "coulomb_disabled", "bonded_disabled",
                                      "long_range_recip_disabled"])
def test_compute_energy_snapshot_cells_pme(solvated, ablation):
    """Every term in float64 within 1e-9 of |term| (1e-6 kcal/mol at
    least); in float32 no further from the float64 reference than twice
    the reference's float32 term (or rel 1e-5): the coulomb term is a
    difference of ~1e5 kcal/mol sums (self energy, exclusion
    correction). Each ablation zeroes its own terms."""
    asys, tops = solvated
    ov = {} if ablation == "none" else {ablation: True}
    ref64, got64 = _snapshots(asys, tops, ov, "float64")
    ref32, got32 = _snapshots(asys, tops, ov, "float32")
    assert set(got64) == set(ref64) == set(got32)
    for k, r in ref64.items():
        assert abs(got64[k] - r) <= max(1e-9 * abs(r), 1e-6), (k, got64[k],
                                                              r)
        assert _near_f64(got32[k], ref32[k], r), (k, got32[k], ref32[k], r)
    off = {"lj_disabled": ("lj",), "coulomb_disabled": ("coulomb",),
           "bonded_disabled": ("bond", "angle", "dihedral"),
           "long_range_recip_disabled": ("recip",)}.get(ablation, ())
    for k in off:
        assert got32[k] == got64[k] == 0.0, k
    if ablation == "none":
        assert all(got32[k] != 0.0 for k in ("bond", "angle", "dihedral",
                                             "lj", "coulomb", "recip"))
