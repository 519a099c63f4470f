"""Port parity: the cluster-pair backend (molchanica_tpu_torch.ops.clusters)
against molchanica_tpu.ops.clusters, on tests/test_clusters.py's 700
random sites in a 26 x 24 x 28 A box (768 padded, ten sites moved whole
boxes outside it), 8 A cutoff, in float64 and float32.

Tolerances: the plan, the Morton codes, the sorted order, the [NC, M]
list and the overflow are equal (both sorts are stable); forces within
1e-6 (float64) / 1e-5 (float32) of max|F| and energies rel 1e-6 / 1e-5
(the float32 sums run in different orders over 3.5e8 kcal/mol of clipped
LJ); the energies' autograd gradient is the analytic force within 1e-9
of max|F| in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.ops import clusters as JCl
from molchanica_tpu.ops.cells import make_xla_direct_force_fn as j_window
from molchanica_tpu.topology import make_topology as j_make_topology
from molchanica_tpu_torch.md.config import MdConfig
from molchanica_tpu_torch.ops import clusters as TCl
from molchanica_tpu_torch.topology import make_topology

torch.set_num_threads(1)

RC = 8.0
BETA = 0.35
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-6),
          "float32": (torch.float32, jnp.float32, 1e-5)}


@pytest.fixture(scope="module")
def system():
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
    tops = {}
    for name, (tdt, jdt, _) in DTYPES.items():
        tops[name] = (
            j_make_topology(np.ones(n) * 12, q, sig, eps, pad_atoms_to=npad,
                            dtype=jdt),
            make_topology(np.ones(n) * 12, q, sig, eps, pad_atoms_to=npad,
                          dtype=tdt))
    return tops, x, box


def _inputs(system, name):
    tops, x, box = system
    tdt, jdt, tol = DTYPES[name]
    jt, tt = tops[name]
    return (jt, tt, jnp.asarray(x, jdt), jnp.asarray(box, jdt),
            torch.tensor(x, dtype=tdt), torch.tensor(box, dtype=tdt), tol)


@pytest.mark.parametrize("cutoff,m_scale,density", [
    (8.0, 1.0, None), (9.0, 1.0, None), (6.0, 2.25, None), (9.0, 1.0, 0.1)])
def test_plan_clusters(cutoff, m_scale, density):
    box = np.array([59.7878, 59.7878, 59.7878])
    args = (box, cutoff, 24940, 25088)
    kw = dict(m_scale=m_scale, density=density)
    ref = JCl.plan_clusters(*args, **kw)
    got = TCl.plan_clusters(*args, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if density is None and cutoff == 9.0:
        # config 3: NC 3,136 and M 288
        assert (got.n_clusters, got.m_neighbors) == (3136, 288)


def test_morton():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 1024, (3, 5000))
    ref = np.asarray(JCl._morton(*(jnp.asarray(a, jnp.int32) for a in c)))
    got = TCl._morton(*(torch.tensor(a) for a in c)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", list(DTYPES))
def test_rebuild_order_and_list(system, name):
    jt, tt, xj, bj, xt, bt, _ = _inputs(system, name)
    n = 700
    plan_j = JCl.plan_clusters(np.asarray(bj), RC, n, 768)
    plan_t = TCl.plan_clusters(np.asarray(bj), RC, n, 768)
    order_j, nbr_j, ovf_j = jax.jit(JCl.make_cluster_rebuild_fn(
        plan_j, jt))(xj, bj)
    order_t, nbr_t, ovf_t = TCl.make_cluster_rebuild_fn(plan_t, tt)(xt, bt)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    assert int(ovf_t) == int(ovf_j) == 0
    # padding sorts last and every real cluster lists itself
    assert (order_t[:n].sort().values == torch.arange(n)).all()
    counts = (nbr_t >= 0).sum(1)
    assert int(counts.max()) <= plan_t.m_neighbors
    own = (nbr_t == torch.arange(plan_t.n_clusters)[:, None]).any(1)
    assert own[:n // 8].all()


@pytest.mark.parametrize("name", list(DTYPES))
def test_overflow_with_m_forced_small(system, name):
    jt, tt, xj, bj, xt, bt, _ = _inputs(system, name)
    plan_j = dataclasses.replace(JCl.plan_clusters(np.asarray(bj), RC, 700,
                                                   768), m_neighbors=32)
    plan_t = TCl.ClusterPlan(**dataclasses.asdict(plan_j))
    _, nbr_j, ovf_j = jax.jit(JCl.make_cluster_rebuild_fn(plan_j, jt))(xj, bj)
    _, nbr_t, ovf_t = TCl.make_cluster_rebuild_fn(plan_t, tt)(xt, bt)
    assert int(ovf_t) == int(ovf_j) > 0
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))


@pytest.mark.parametrize("name", list(DTYPES))
def test_direct_force(system, name):
    jt, tt, xj, bj, xt, bt, tol = _inputs(system, name)
    cfg_j = JCfg(lj_cutoff=RC, coulomb_cutoff=RC, dtype=name)
    cfg_t = MdConfig(lj_cutoff=RC, coulomb_cutoff=RC, dtype=name)
    plan_j = JCl.plan_clusters(np.asarray(bj), RC, 700, 768)
    plan_t = TCl.plan_clusters(np.asarray(bj), RC, 700, 768)
    order_j, nbr_j, _ = jax.jit(JCl.make_cluster_rebuild_fn(plan_j, jt))(
        xj, bj)
    order_t, nbr_t, _ = TCl.make_cluster_rebuild_fn(plan_t, tt)(xt, bt)
    dj = JCl.make_cluster_direct_force_fn(jt, cfg_j, plan_j)
    one_j = jnp.asarray(1.0, xj.dtype)
    f_j, elj_j, ec_j = jax.jit(lambda x_, o_, n_: dj(
        x_, bj, one_j, BETA, o_, n_)[:3])(xj, order_j, nbr_j)
    dt = TCl.make_cluster_direct_force_fn(tt, cfg_t, plan_t)
    f_t, elj_t, ec_t, ovf = dt(xt, bt, torch.tensor(1.0, dtype=xt.dtype),
                               BETA, order_t, nbr_t)
    f_j = np.asarray(f_j)
    assert f_t.dtype == xt.dtype and int(ovf) == 0
    assert np.abs(f_t.numpy() - f_j).max() <= tol * np.abs(f_j).max()
    assert abs(float(elj_t) - float(elj_j)) <= tol * abs(float(elj_j))
    assert abs(float(ec_t) - float(ec_j)) <= tol * abs(float(ec_j))
    # padding rows carry no force
    assert not f_t[700:].any()


def test_stale_list_and_window(system):
    """tests/test_clusters.py's two checks on the port: the clusters match
    the reference's dense window at the list's positions, and a list built
    with the skin still holds every pair after moves of up to 0.25 A."""
    jt, tt, xj, bj, xt, bt, _ = _inputs(system, "float64")
    cfg_j = JCfg(lj_cutoff=RC, coulomb_cutoff=RC, dtype="float64")
    cfg_t = MdConfig(lj_cutoff=RC, coulomb_cutoff=RC, dtype="float64")
    plan = TCl.plan_clusters(np.asarray(bj), RC, 700, 768)
    order, nbr, _ = TCl.make_cluster_rebuild_fn(plan, tt)(xt, bt)
    direct = TCl.make_cluster_direct_force_fn(tt, cfg_t, plan)
    one = torch.tensor(1.0, dtype=torch.float64)
    rng = np.random.default_rng(1)
    x = np.asarray(xj)
    x2 = x + rng.normal(0, 0.08, x.shape).clip(-0.25, 0.25)
    for xx in (x, x2):
        win = j_window(jt, cfg_j, np.asarray(bj), x0=xx)
        f_w, elj_w, ec_w, _ = jax.jit(lambda x_: win(
            x_, bj, jnp.asarray(1.0), BETA))(jnp.asarray(xx))
        f, elj, ec, _ = direct(torch.tensor(xx), bt, one, BETA, order, nbr)
        np.testing.assert_allclose(float(elj), float(elj_w), rtol=1e-8)
        np.testing.assert_allclose(float(ec), float(ec_w), rtol=1e-8)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_w), rtol=1e-6,
                                   atol=1e-7)


def test_energy_gradient_is_the_force(system):
    """The energies are differentiable (the barostat takes dE/ds through
    them): -d(e_lj + e_c)/dx equals the analytic force, and stats' f_abs
    bounds each site's force."""
    _, tt, _, _, xt, bt, _ = _inputs(system, "float64")
    cfg = MdConfig(lj_cutoff=RC, coulomb_cutoff=RC, dtype="float64")
    plan = TCl.plan_clusters(bt.numpy(), RC, 700, 768)
    order, nbr, _ = TCl.make_cluster_rebuild_fn(plan, tt)(xt, bt)
    direct = TCl.make_cluster_direct_force_fn(tt, cfg, plan)
    one = torch.tensor(1.0, dtype=torch.float64)
    stats = {}
    f, _, _, _ = direct(xt, bt, one, BETA, order, nbr, stats=stats)
    xg = xt.clone().requires_grad_(True)
    f_none, e_lj, e_c, _ = direct(xg, bt, one, BETA, order, nbr,
                                  want_force=False)
    assert f_none is None
    (g,) = torch.autograd.grad(e_lj + e_c, xg)
    assert float((g + f).abs().max()) <= 1e-9 * float(f.abs().max())
    fa = stats["f_abs"]
    assert (f.abs().amax(1) <= fa * (1 + 1e-9) + 1e-12).all()
    assert stats["e_abs_lj"] >= abs(float(e_lj.detach())) * 0.999
