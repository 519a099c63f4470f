"""Port parity: rolled SETTLE, the integrator steps and the state helpers
(molchanica_tpu_torch.md) against molchanica_tpu.md on the CPU.

Tolerances: SETTLE positions and velocities within 1e-5 (A, A/ps);
integrator steps within 1e-5 of scale; kinetic energy rel 1e-6. The
Maxwell-Boltzmann draw uses torch's generator, so it is held to
statistics only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md import integrators as JI
from molchanica_tpu.md import settle as JS
from molchanica_tpu.md import state as JST
from molchanica_tpu.systems.water import OPC, water_geometry
from molchanica_tpu_torch.md import integrators as TI
from molchanica_tpu_torch.md import settle as TS
from molchanica_tpu_torch.md import state as TST

torch.set_num_threads(1)
M_O, M_H = 15.999, 1.008


@pytest.fixture(scope="module")
def waters():
    """Blocked 4-site waters (O, H1, H2, M) with a few solute slots in
    front, rigid old positions, perturbed new positions and velocities."""
    rng = np.random.default_rng(0)
    nw, pre = 200, 5
    geom = water_geometry(OPC)
    q = rng.normal(size=(nw, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, a, b, c = q.T
    rot = np.stack([
        np.stack([1 - 2 * (b * b + c * c), 2 * (a * b - w * c),
                  2 * (a * c + w * b)], -1),
        np.stack([2 * (a * b + w * c), 1 - 2 * (a * a + c * c),
                  2 * (b * c - w * a)], -1),
        np.stack([2 * (a * c - w * b), 2 * (b * c + w * a),
                  1 - 2 * (a * a + b * b)], -1)], axis=1)
    box = np.array([20.0, 20.0, 20.0], np.float32)
    centers = rng.uniform(0, 20, (nw, 3))
    sites = np.einsum("wij,sj->wsi", rot, geom) + centers[:, None, :]
    x_old = np.concatenate([rng.uniform(0, 20, (pre, 3)),
                            sites.reshape(-1, 3)]).astype(np.float32)
    x_new = (x_old + rng.normal(0, 0.03, x_old.shape)).astype(np.float32)
    v = rng.normal(0, 5.0, x_old.shape).astype(np.float32)
    m_o = np.zeros(len(x_old), bool)
    m_o[pre::4] = True
    return x_old, x_new, v, m_o, box


@pytest.mark.parametrize("boxed", [False, True])
def test_settle_positions_rolled(waters, boxed):
    x_old, x_new, _, m_o, box = waters
    ra, rb, rc = TS.settle_params(OPC.r_oh, OPC.theta_hoh, M_O, M_H)
    assert (ra, rb, rc) == JS.settle_params(OPC.r_oh, OPC.theta_hoh, M_O,
                                            M_H)
    b = box if boxed else None
    ref = np.asarray(JS.settle_compute_rolled(
        jnp.asarray(x_new), jnp.asarray(x_old), jnp.asarray(m_o), ra, rb,
        rc, M_O, M_H, box=None if b is None else jnp.asarray(b)))
    got = TS.settle_compute_rolled(
        torch.tensor(x_new), torch.tensor(x_old), torch.tensor(m_o), ra, rb,
        rc, M_O, M_H, box=None if b is None else torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # rigid geometry restored
    o, h1 = got[5::4], got[6::4]
    np.testing.assert_allclose(np.linalg.norm(h1 - o, axis=1), OPC.r_oh,
                               atol=1e-4)


@pytest.mark.parametrize("boxed", [False, True])
def test_settle_velocities_rolled(waters, boxed):
    x_old, _, v, m_o, box = waters
    b = box if boxed else None
    ref = np.asarray(JS.settle_velocities_rolled(
        jnp.asarray(v), jnp.asarray(x_old), jnp.asarray(m_o), M_O, M_H,
        box=None if b is None else jnp.asarray(b)))
    got = TS.settle_velocities_rolled(
        torch.tensor(v), torch.tensor(x_old), torch.tensor(m_o), M_O, M_H,
        box=None if b is None else torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _toy(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    v = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    m = rng.uniform(1.0, 16.0, n).astype(np.float32)
    dof = (rng.uniform(size=n) > 0.1).astype(np.float32)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    return x, v, m, dof, noise


@pytest.mark.parametrize("kind,gamma,cap,cadence", [
    ("verlet_velocity", 0.0, None, "light"),
    ("langevin_middle", 1.0, None, "light"),
    ("langevin_middle", 5.0, 30.0, "light"),
    ("langevin_middle", 0.0, None, "light"),
    ("langevin_middle", 1.0, None, "strict"),
    ("langevin_middle", 5.0, 30.0, "strict")])
def test_integrator_step(kind, gamma, cap, cadence):
    x, v, m, dof, noise = _toy()
    kx = np.float32(40.0)

    def jforce(xx, box, couple):
        return -kx * xx, (0.5 * kx * jnp.sum(xx * xx), {})

    def tforce(xx):
        return -kx * xx, (0.5 * kx * torch.sum(xx * xx), {})

    # toy constraints, identical in both frameworks: rescale each position
    # to its radius in x_ref, and drop the radial part of each velocity
    def jcp(xn, xr):
        return xn * (jnp.linalg.norm(xr, axis=1, keepdims=True)
                     / jnp.linalg.norm(xn, axis=1, keepdims=True))

    def tcp(xn, xr):
        return xn * (torch.linalg.norm(xr, dim=1, keepdim=True)
                     / torch.linalg.norm(xn, dim=1, keepdim=True))

    def jcv(vv, xx):
        u = xx / jnp.linalg.norm(xx, axis=1, keepdims=True)
        return vv - jnp.sum(vv * u, axis=1, keepdims=True) * u

    def tcv(vv, xx):
        u = xx / torch.linalg.norm(xx, dim=1, keepdim=True)
        return vv - torch.sum(vv * u, dim=1, keepdim=True) * u

    common = dict(dt=0.002, temp_target=300.0, thermostat_tau=None,
                  gamma=gamma, force_cap=cap, cadence=cadence)
    js = JI.make_integrator_step(jforce, jnp.asarray(m), jnp.asarray(dof),
                                 kind, constrain_positions=jcp,
                                 constrain_velocities=jcv, **common)
    ts = TI.make_integrator_step(tforce, torch.tensor(m), torch.tensor(dof),
                                 kind, constrain_positions=tcp,
                                 constrain_velocities=tcv, **common)
    f0 = -kx * x
    xj, vj, fj = jnp.asarray(x), jnp.asarray(v), jnp.asarray(f0)
    xt, vt, ft = torch.tensor(x), torch.tensor(v), torch.tensor(f0)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        xj, vj, fj, ej, _, key = js(xj, vj, fj, None, None, key,
                                    noise=jnp.asarray(noise))
        xt, vt, ft, et, _ = ts(xt, vt, ft, torch.tensor(noise))
    for got, ref in ((xt, xj), (vt, vj), (ft, fj)):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert abs(float(et) - float(ej)) <= 1e-5 * abs(float(ej))


def test_kinetic_energy_and_com_drift():
    x, v, m, dof, _ = _toy(seed=4)
    ke_j = float(JST.kinetic_energy(jnp.asarray(v), jnp.asarray(m),
                                    jnp.asarray(dof)))
    ke_t = float(TST.kinetic_energy(torch.tensor(v), torch.tensor(m),
                                    torch.tensor(dof)))
    assert abs(ke_t - ke_j) <= 1e-6 * ke_j
    ref = np.asarray(JST.remove_com_drift(jnp.asarray(v), jnp.asarray(m),
                                          jnp.asarray(dof)))
    got = TST.remove_com_drift(torch.tensor(v), torch.tensor(m),
                               torch.tensor(dof)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_init_velocities_statistics():
    rng = np.random.default_rng(5)
    n = 20000
    m = torch.tensor(rng.uniform(1.0, 16.0, n), dtype=torch.float32)
    dof = torch.ones(n)
    dof[::10] = 0.0
    gen = torch.Generator().manual_seed(11)
    v = TST.init_velocities(gen, m, dof, 310.0)
    p = torch.sum(v * (m * dof)[:, None], dim=0)
    assert float(p.abs().max()) < 1e-2 * float(m.sum())
    assert float(v[dof == 0].abs().max()) == 0.0
    ke = float(TST.kinetic_energy(v, m, dof))
    ndof = 3.0 * float(dof.sum()) - 3.0
    t = 2.0 * ke / (0.001987204259 * ndof)
    assert abs(t - 310.0) < 0.03 * 310.0
    v2 = TST.init_velocities(torch.Generator().manual_seed(11), m, dof,
                             310.0)
    assert torch.equal(v, v2)
