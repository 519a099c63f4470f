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
from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.md.config import MdConfig
from molchanica_tpu_torch.ops import clusters as TCl
from molchanica_tpu_torch.ops.exclusions import Exclusions, exclusion_table
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
    order_t, nbr_t, flags_t, ovf_t = TCl.make_cluster_rebuild_fn(
        plan_t, tt, exclusion_table(tt))(xt, bt)
    assert not flags_t.any()          # the random sites exclude no pair
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
    _, nbr_t, _, ovf_t = TCl.make_cluster_rebuild_fn(
        plan_t, tt, exclusion_table(tt))(xt, bt)
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
    order_t, nbr_t, flags_t, _ = TCl.make_cluster_rebuild_fn(
        plan_t, tt, exclusion_table(tt))(xt, bt)
    dj = JCl.make_cluster_direct_force_fn(jt, cfg_j, plan_j)
    one_j = jnp.asarray(1.0, xj.dtype)
    f_j, elj_j, ec_j = jax.jit(lambda x_, o_, n_: dj(
        x_, bj, one_j, BETA, o_, n_)[:3])(xj, order_j, nbr_j)
    dt = TCl.make_cluster_direct_force_fn(
        tt, cfg_t, plan_t, exclusion_table(tt))
    f_t, elj_t, ec_t, ovf = dt(xt, bt, torch.tensor(1.0, dtype=xt.dtype),
                               BETA, order_t, nbr_t, flags_t)
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
    order, nbr, flags, _ = TCl.make_cluster_rebuild_fn(
        plan, tt, exclusion_table(tt))(xt, bt)
    direct = TCl.make_cluster_direct_force_fn(
        tt, cfg_t, plan, exclusion_table(tt))
    one = torch.tensor(1.0, dtype=torch.float64)
    rng = np.random.default_rng(1)
    x = np.asarray(xj)
    x2 = x + rng.normal(0, 0.08, x.shape).clip(-0.25, 0.25)
    for xx in (x, x2):
        win = j_window(jt, cfg_j, np.asarray(bj), x0=xx)
        f_w, elj_w, ec_w, _ = jax.jit(lambda x_: win(
            x_, bj, jnp.asarray(1.0), BETA))(jnp.asarray(xx))
        f, elj, ec, _ = direct(torch.tensor(xx), bt, one, BETA, order, nbr,
                               flags)
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
    order, nbr, flags, _ = TCl.make_cluster_rebuild_fn(
        plan, tt, exclusion_table(tt))(xt, bt)
    direct = TCl.make_cluster_direct_force_fn(
        tt, cfg, plan, exclusion_table(tt))
    one = torch.tensor(1.0, dtype=torch.float64)
    stats = {}
    f, _, _, _ = direct(xt, bt, one, BETA, order, nbr, flags, stats=stats)
    xg = xt.clone().requires_grad_(True)
    f_none, e_lj, e_c, _ = direct(xg, bt, one, BETA, order, nbr, flags,
                                  want_force=False)
    assert f_none is None
    (g,) = torch.autograd.grad(e_lj + e_c, xg)
    assert float((g + f).abs().max()) <= 1e-9 * float(f.abs().max())
    fa = stats["f_abs"]
    assert (f.abs().amax(1) <= fa * (1 + 1e-9) + 1e-12).all()
    assert stats["e_abs_lj"] >= abs(float(e_lj.detach())) * 0.999


def _replicas(system, name, m_scale=1.0):
    """Three replicas of the system (jittered by 0.1 A), their plan,
    rebuilt lists and the direct-space function."""
    _, tt, _, _, xt, bt, _ = _inputs(system, name)
    cfg = MdConfig(lj_cutoff=RC, coulomb_cutoff=RC, dtype=name)
    plan = TCl.plan_clusters(bt.numpy(), RC, 700, 768, m_scale=m_scale)
    rebuild = TCl.make_cluster_rebuild_fn(plan, tt, exclusion_table(tt))
    rng = np.random.default_rng(3)
    xs = torch.stack([xt + torch.tensor(rng.normal(0, 0.1, xt.shape),
                                        dtype=xt.dtype) for _ in range(3)])
    lists = [rebuild(x, bt) for x in xs]
    order = torch.stack([o for o, _, _, _ in lists])
    nbr = torch.stack([nb for _, nb, _, _ in lists])
    flags = torch.stack([m for _, _, m, _ in lists])
    assert all(int(ovf) == 0 for _, _, _, ovf in lists)
    return tt, cfg, plan, xs, bt, order, nbr, flags


@pytest.mark.parametrize("want_force", [True, False])
@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_replica_axis_equals_single_calls(system, name, want_force):
    """The plain twin with a leading replica axis (as the farm calls it on
    the CPU) gives each replica's single call, and the CPU dispatch is the
    plain twin."""
    tt, cfg, plan, xs, bt, order, nbr, flags = _replicas(system, name)
    direct = TCl.make_cluster_direct_force_fn(
        tt, cfg, plan, exclusion_table(tt))
    couples = torch.tensor([1.0, 0.5, 0.25], dtype=xs.dtype)
    f_b, elj_b, ec_b, ovf_b = direct.plain(xs, bt, couples, BETA, order,
                                           nbr, flags, want_force)
    got = direct(xs, bt, couples, BETA, order, nbr, flags, want_force)
    assert elj_b.shape == ec_b.shape == ovf_b.shape == (3,)
    assert (f_b is None) == (not want_force)
    for r in range(3):
        f1, elj1, ec1, _ = direct.plain(xs[r], bt, couples[r], BETA,
                                        order[r], nbr[r], flags[r],
                                        want_force)
        if want_force:
            scale = float(f1.abs().max())
            assert float((f_b[r] - f1).abs().max()) <= 1e-12 * scale
            assert torch.equal(got[0][r], f_b[r])
        for e_b, e1, e_d in ((elj_b, elj1, got[1]), (ec_b, ec1, got[2])):
            assert abs(float(e_b[r] - e1)) <= 1e-12 * abs(float(e1))
            assert float(e_d[r]) == float(e_b[r])
    with pytest.raises(ValueError, match="one replica"):
        direct.plain(xs, bt, couples, BETA, order, nbr, flags, stats={})


@pytest.mark.parametrize("m_scale", [1.0, 1.5])
@pytest.mark.parametrize("name", list(DTYPES))
def test_rebuild_rows_are_compacted(system, name, m_scale):
    """Every row of the list holds its listed clusters before its -1
    padding (the kernel stops a row at its first group of unlisted
    slots), at the planned and at the replanned width, on the stored and
    the jittered positions; rows do have padding."""
    _, _, plan, xs, bt, order, nbr, _ = _replicas(system, name, m_scale)
    _, tt, _, _, xt, _, _ = _inputs(system, name)
    nbrs = [TCl.make_cluster_rebuild_fn(plan, tt, exclusion_table(tt))(
        xt, bt)[1], *nbr]
    for nb in nbrs:
        listed = nb >= 0
        assert not (listed[:, 1:] & ~listed[:, :-1]).any()
        assert (~listed).any() and listed[:, 0].any()
        # listed clusters ascend within a row, each once
        ok = listed[:, 1:] & listed[:, :-1]
        assert (nb[:, 1:] > nb[:, :-1])[ok].all()


def test_cluster_force_cuda_checks(system):
    """The kernel's wrapper raises on CPU tensors and on shapes, dtypes
    and layouts the kernel does not take, before any launch; CPU tensors
    take the plain twin and count no launch."""
    _, tt, _, _, xt, bt, _ = _inputs(system, "float32")
    cfg = MdConfig(lj_cutoff=RC, coulomb_cutoff=RC, dtype="float32")
    plan = TCl.plan_clusters(bt.numpy(), RC, 700, 768)
    order, nbr, flags, _ = TCl.make_cluster_rebuild_fn(
        plan, tt, exclusion_table(tt))(xt, bt)
    rows = TCl.direct_rows(tt)
    excl = exclusion_table(tt)
    args = dict(x=xt, box=bt, couple=1.0, beta=BETA, order=order, nbr=nbr,
                flags=flags, excl=excl, rows=rows, rc2=RC * RC)

    def call(**kw):
        TCl.cluster_force_cuda(plan, **{**args, **kw})

    before = tracing.counters("cluster_force")
    with pytest.raises(ValueError, match="CUDA device"):
        call()
    for kw in (dict(x=xt[:-8]), dict(nbr=nbr[:, :-1]), dict(order=order[1:]),
               dict(flags=flags[:, :-1]),
               dict(excl=Exclusions.empty(700)),
               dict(x=xt[None].repeat(2, 1, 1)), dict(rows=rows[:, :4]),
               dict(couple=torch.ones(3)), dict(box=bt[:2]),
               dict(x=xt[None, None])):
        with pytest.raises(ValueError, match="shapes"):
            call(**kw)
    for kw in (dict(order=order.int()), dict(nbr=nbr.int()),
               dict(flags=flags.int()),
               dict(excl=Exclusions(excl.bits.long(), excl.pairs)),
               dict(rows=rows.double()),
               dict(x=xt.half(), rows=rows.half())):
        with pytest.raises(ValueError, match="dtypes"):
            call(**kw)
    for kw in (dict(x=xt.T.contiguous().T),
               dict(nbr=nbr.T.contiguous().T),
               dict(flags=flags.T.contiguous().T),
               dict(rows=rows.T.contiguous().T)):
        with pytest.raises(ValueError, match="contiguous"):
            call(**kw)
    # replicas a padded stride apart (as vmap's placed sites lie) pass
    xr = torch.zeros((2, 769, 3))[:, :768]
    xr.copy_(xt.expand(2, -1, -1))
    with pytest.raises(ValueError, match="CUDA device"):
        call(x=xr, order=order.expand(2, -1).contiguous(),
             nbr=nbr.expand(2, -1, -1).contiguous(),
             flags=flags.expand(2, -1, -1).contiguous())
    direct = TCl.make_cluster_direct_force_fn(
        tt, cfg, plan, exclusion_table(tt))
    f, _, _, _ = direct(xt, bt, torch.tensor(1.0), BETA, order, nbr, flags)
    assert f.shape == (768, 3)
    assert tracing.counters("cluster_force") == before


def test_engine_takes_the_plain_twin_by_name(system, monkeypatch):
    """MdSim on clusters asks the plain twin, by name, for the
    direct-space scales and for the barostat's differentiable energy (the
    kernel has no gradient), and the pressure is the one the dispatching
    function gave before the kernel, which on the CPU is the plain twin
    too."""
    from molchanica_tpu_torch.md import engine as E
    from molchanica_tpu_torch.md.barostat import scaling_pressure_bar
    from molchanica_tpu_torch.md.config import BarostatCfg
    from molchanica_tpu_torch.md.energy import (apply_virtual_sites,
                                                make_energy_fn)

    _, tt, _, _, xt, bt, _ = _inputs(system, "float64")
    calls = {"direct": 0, "plain": 0}
    real = E.make_cluster_direct_force_fn

    def counted(top, cfg, plan, excl):
        d = real(top, cfg, plan, excl)

        def direct(*a, **kw):
            calls["direct"] += 1
            return d(*a, **kw)

        def plain(*a, **kw):
            calls["plain"] += 1
            return d.plain(*a, **kw)

        direct.plain = plain
        return direct

    monkeypatch.setattr(E, "make_cluster_direct_force_fn", counted)
    cfg = MdConfig(lj_cutoff=RC, coulomb_cutoff=RC, dtype="float64",
                   barostat_cfg=BarostatCfg(pressure_target=1.0, tau=0.1))
    rng = np.random.default_rng(8)
    v = rng.normal(0, 0.01, (768, 3))
    v[700:] = 0.0
    md = E.MdSim(tt, cfg, xt.numpy(), box_extent=bt.numpy(),
                 method="cells_pme", relax=False, velocities=v,
                 device="cpu")
    assert md._nbr_backend == "clusters"
    s = md.state
    x, box, vel = s.positions, s.box, s.velocities
    with torch.no_grad():
        nbr, _ = md._rebuild_nbr(apply_virtual_sites(x, tt), box)
    calls.update(direct=0, plain=0)
    kw = dict(mol_id=tt.mol_id, n_mol=tt.n_mol)
    p = scaling_pressure_bar(lambda a, b, c: md._energy_nbr(a, b, c, nbr),
                             x, box, vel, tt.masses, tt.dof_mask, s.couple,
                             **kw)
    assert calls == {"direct": 0, "plain": 1}
    md.direct_space_scales(x)
    assert calls == {"direct": 0, "plain": 2}
    rest_e = make_energy_fn(tt, md.cfg, "pme_rest", pme_recip_fn=md._recip)

    def e_before(a, b, c):
        a = apply_virtual_sites(a, tt)
        _, e_lj, e_c, _ = md._direct(a, b, c, md._beta, *nbr,
                                     want_force=False)
        return rest_e(a, b, c)[0] + e_lj + e_c

    p0 = scaling_pressure_bar(e_before, x, box, vel, tt.masses, tt.dof_mask,
                              s.couple, **kw)
    assert calls["direct"] == 1
    assert torch.isfinite(p) and float(p) == float(p0)
