"""Port parity: bonded energies and order-6 PME3 (molchanica_tpu_torch.ops)
against molchanica_tpu.ops on the CPU.

Tolerances: energies rel < 1e-5, forces < 1e-5 of the largest force
component. The PME3 reference runs the JAX function in float64 (the port
runs float32): the reference's own float32 energy reduction carries
~1e-5 relative error on these inputs, the port's ~1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.ops import bonded as JB
from molchanica_tpu.ops import pme as JP
from molchanica_tpu.ops import pme3 as JP3
from molchanica_tpu.systems.bench_systems import build_polyalanine
from molchanica_tpu.topology import make_topology as j_make_topology
from molchanica_tpu_torch.ops import bonded as TB
from molchanica_tpu_torch.ops import pme as TP
from molchanica_tpu_torch.ops import pme3 as TP3

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def peptide():
    m = build_polyalanine(6, seed=2)
    top = j_make_topology(m.masses, m.charges, m.lj_sigma, m.lj_eps,
                          bonds=m.bonds, angles=m.angles,
                          dihedrals=m.dihedrals)
    rng = np.random.default_rng(0)
    x = (m.positions + rng.normal(0, 0.05, m.positions.shape)
         + 10.0).astype(np.float32)
    return top, x


@pytest.mark.parametrize("term", ["bond", "angle", "dihedral"])
@pytest.mark.parametrize("boxed", [False, True])
def test_bonded_energy_and_forces(peptide, term, boxed):
    top, x = peptide
    box = np.array([14.0, 15.0, 16.0], np.float32) if boxed else None
    if term == "bond":
        args = ("bond_idx", "bond_k", "bond_r0")
    elif term == "angle":
        args = ("angle_idx", "angle_k", "angle_theta0")
    else:
        args = ("dihedral_idx", "dihedral_k", "dihedral_n",
                "dihedral_phase")
    jf = getattr(JB, f"{term}_energy")
    tf = getattr(TB, f"{term}_energy")
    jargs = [getattr(top, a) for a in args]
    targs = [torch.tensor(np.asarray(a)) for a in jargs]
    targs[0] = targs[0].long()
    jbox = None if box is None else jnp.asarray(box)
    tbox = None if box is None else torch.tensor(box)
    e_ref, g_ref = jax.value_and_grad(
        lambda xx: jf(xx, jbox, *jargs))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    e = tf(xt, tbox, *targs)
    (g,) = torch.autograd.grad(e, xt)
    e = e.detach()
    e_ref = float(np.float32(e_ref))
    assert abs(float(e) - e_ref) <= 1e-5 * abs(e_ref)
    g_ref = np.asarray(g_ref, np.float32)
    assert np.abs(g.numpy() - g_ref).max() <= 1e-5 * np.abs(g_ref).max()


def test_ewald_helpers_equal():
    for rc in (6.0, 9.0, 10.0):
        assert TP.ewald_beta_for(rc, 1e-5) == JP.ewald_beta_for(rc, 1e-5)
    for n in (16, 47, 50, 61, 97):
        assert TP.good_fft_size(n) == JP.good_fft_size(n)
    for box in ((24.0, 24.0, 24.0), (59.7878,) * 3, (30.0, 41.0, 52.0)):
        beta = JP.ewald_beta_for(9.0, 1e-5)
        assert TP3.default_grid6(box, beta) == JP3.default_grid6(box, beta)
    assert TP3.default_grid6((59.7878,) * 3,
                             JP.ewald_beta_for(9.0, 1e-5)) == (50, 50, 50)


def _charges(n, rng):
    q = rng.normal(size=n).astype(np.float32)
    return q - q.mean()


@pytest.mark.parametrize("grid,n", [((24, 24, 24), 1500),
                                    ((20, 25, 30), 700)])
def test_pme3_energy_and_forces(grid, n):
    rng = np.random.default_rng(0)
    box = np.array([24.0, 25.0, 26.0], np.float32)
    x = rng.uniform(-2.0, 28.0, (n, 3)).astype(np.float32)
    q = _charges(n, rng)
    beta = 0.45
    ref = JP3.make_pme3_recip_fn(grid, beta, order=6, dtype=jnp.float64,
                                 custom_grad=True)
    (e_ref, (gx_ref, gq_ref)) = jax.value_and_grad(
        lambda xx, qq: ref(xx, qq, jnp.asarray(box, jnp.float64)),
        argnums=(0, 1))(jnp.asarray(x, jnp.float64),
                        jnp.asarray(q, jnp.float64))
    pme = TP3.make_pme3_recip_fn(grid, beta, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    bt = torch.tensor(box, requires_grad=True)
    e = pme(xt, qt, bt)
    gx, gq, gb = torch.autograd.grad(e, (xt, qt, bt))
    e = e.detach()
    e_ref = float(e_ref)
    assert abs(float(e) - e_ref) <= 1e-5 * abs(e_ref)
    for got, r in ((gx, gx_ref), (gq, gq_ref)):
        r = np.asarray(r, np.float32)
        assert np.abs(got.numpy() - r).max() <= 1e-5 * np.abs(r).max()
    # the box gradient (the MdSim barostat's virial): the reference's
    # custom_grad=False form takes it by autodiff
    plain = JP3.make_pme3_recip_fn(grid, beta, order=6, dtype=jnp.float64)
    gb_ref = np.asarray(jax.grad(lambda bb: plain(
        jnp.asarray(x, jnp.float64), jnp.asarray(q, jnp.float64), bb))(
        jnp.asarray(box, jnp.float64)))
    assert np.abs(gb.numpy() - gb_ref).max() <= 1e-5 * np.abs(gb_ref).max()
    e2, gx2 = pme.value_and_grad(torch.tensor(x), torch.tensor(q),
                                 torch.tensor(box))
    assert float(e2) == float(e)
    assert torch.equal(gx2, gx)


def test_pme3_matches_reference_float32_path():
    """The engine's float32 reference path, to its own accuracy."""
    rng = np.random.default_rng(3)
    box = np.array([24.0, 24.0, 24.0], np.float32)
    x = rng.uniform(0.0, 24.0, (900, 3)).astype(np.float32)
    q = _charges(900, rng)
    ref = JP3.make_pme3_recip_fn((24, 24, 24), 0.5, order=6,
                                 dtype=jnp.float32, custom_grad=True)
    e_ref, g_ref = jax.value_and_grad(
        lambda xx: ref(xx, jnp.asarray(q), jnp.asarray(box)))(
            jnp.asarray(x))
    e, g = TP3.make_pme3_recip_fn((24, 24, 24), 0.5,
                                  device="cpu").value_and_grad(
        torch.tensor(x), torch.tensor(q), torch.tensor(box))
    e_ref = float(np.float32(e_ref))
    assert abs(float(e) - e_ref) <= 3e-5 * abs(e_ref)
    g_ref = np.asarray(g_ref, np.float32)
    assert np.abs(g.numpy() - g_ref).max() <= 1e-5 * np.abs(g_ref).max()
