"""Port parity: the colpair host side and the plain kernel twin
(molchanica_tpu_torch.ops.colpair) against molchanica_tpu.ops.pallas.colpair
on the CPU, with the Pallas kernel in interpret mode.

Tolerances: plan coefficients and every integer table (perm, keys,
col_start, wl, nw, overflow) exactly equal; kernel forces
max|dF|/max|F| < 1e-5 and energies rel < 1e-5 (float32 summation order
only); the plain version in float32 against its float64 run, per site
< 5e-6 of the site's sum of pair-force term magnitudes and per cluster
< 2e-6 of its sum of pair-energy term magnitudes; pair-list energies
rel < 1e-5 and forces < 1e-5 of scale. The has_alch (softcore) instances
are held to the same tolerances with the first ten solute atoms coupled,
at couple 1.0, 0.5 and 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.ops.pallas import colpair as J
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.fast_engine import FastSim
from molchanica_tpu_torch.ops import colpair as T
from molchanica_tpu_torch.systems.bench_systems import build_solvated_protein

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim():
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=1.0),
                   lj_cutoff=6.0, coulomb_cutoff=6.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   max_init_relaxation_iters=None, seed=3)
    v0 = np.zeros(asys.positions.shape, np.float32)
    return FastSim(asys.topology, cfg, asys.positions,
                   box_extent=asys.box_extent, velocities=v0, device="cpu")


def _j(t):
    return jnp.asarray(t.detach().cpu().numpy())


def _jplan(plan):
    """The reference ColPlan with the port plan's fields."""
    import dataclasses
    return J.ColPlan(**{f.name: getattr(plan, f.name)
                        for f in dataclasses.fields(J.ColPlan)})


@pytest.mark.parametrize("box,rc,r_blob", [
    ((24.0, 24.0, 24.0), 6.0, 0.87243),
    ((59.7878, 59.7878, 59.7878), 9.0, 0.87243),
    ((40.0, 45.0, 50.0), 9.0, 0.0)])
def test_plan_columns_equal(box, rc, r_blob):
    from molchanica_tpu_torch.ops.pme import ewald_beta_for
    beta = ewald_beta_for(rc, 1e-5)
    skin = min(1.2, min(box) / 3.0 - rc - 2.0 * r_blob - 1e-6)
    jp = J.plan_columns(np.asarray(box), rc, beta, 20000, 20480, skin=skin,
                        r_blob=r_blob)
    tp = T.plan_columns(np.asarray(box), rc, beta, 20000, 20480, skin=skin,
                        r_blob=r_blob)
    for f in ("nx", "ny", "wx", "wy", "lz", "n_sorted", "n_base", "cutoff",
              "skin", "beta", "erfcx_coeffs", "kpoly_coeffs", "kpoly_xmax",
              "r_blob", "rings", "offsets"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.n_clusters == jp.n_clusters and tp.rc_wb == jp.rc_wb


def test_fit_coefficients_equal():
    for xmax in (1.87, 2.81, 3.2):
        np.testing.assert_array_equal(T.erfcx_cheb_coeffs(xmax),
                                      J.erfcx_cheb_coeffs(xmax))
        np.testing.assert_array_equal(T.coulomb_kpoly_coeffs(xmax),
                                      J.coulomb_kpoly_coeffs(xmax))


def _sort_inputs(sim):
    """Base-order wrapped positions of the live state, as _rebuild makes."""
    x = sim.positions_unsorted()
    box = sim.state.box
    xw = torch.tensor(x) - box * torch.floor(torch.tensor(x) / box)
    return xw, box


def test_anchor_sort_equal(sim):
    aid, sizes, mask = _anchor_args(sim)
    xw, box = _sort_inputs(sim)
    rng = np.random.default_rng(1)
    # jitter so keys tie and cross bin edges differently from the build
    xj = xw + torch.tensor(rng.normal(0, 0.3, xw.shape), dtype=torch.float32)
    for xs in (xw, xj):
        got = T.make_anchor_sort_fn(sim.plan, aid, sizes, mask,
                                    device="cpu")(xs, box)
        ref = J.make_anchor_sort_fn(_jplan(sim.plan), aid, sizes, mask)(
            _j(xs), _j(box))
        for name, a, b in zip(("perm", "keys", "col_start", "overflow"),
                              got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def _anchor_args(sim):
    top = sim.top
    ws, stride, wc = top.water_start, top.water_site_count, top.water_count
    n = sim.n_base
    aid = np.concatenate([np.arange(ws), ws + stride * np.arange(wc),
                          np.arange(ws + stride * wc, n)])
    sizes = np.concatenate([np.ones(ws), np.full(wc, stride),
                            np.ones(n - ws - stride * wc)]).astype(np.int64)
    return aid, sizes, top.atom_mask.numpy()


def _master_sorted(sim, jitter=0.0):
    """(sorted x, keys, atom mask) of the master sort of the live state."""
    xw, box = _sort_inputs(sim)
    if jitter:
        rng = np.random.default_rng(2)
        xw = xw + torch.tensor(rng.normal(0, jitter, xw.shape),
                               dtype=torch.float32)
    perm, keys, _, _ = sim._anchor_sort(xw, box)
    xs = torch.cat([xw, torch.full((1, 3), 1e6)])[perm]
    return xs, keys, sim._props_base[perm][:, 4]


@pytest.mark.parametrize("jitter", [0.0, 0.4])
@pytest.mark.parametrize("psk", [64, 8])
def test_window_tables_equal(sim, jitter, psk):
    """Master tables; psk=8 overflows, and both report the same excess."""
    xs, keys, mask = _master_sorted(sim, jitter)
    box = sim.state.box
    got = T.make_window_fn(sim.plan, per_slice_k=psk)(xs, keys, box, mask)
    ref = J.make_window_fn(_jplan(sim.plan), triangular=True,
                           per_slice_k=psk)(_j(xs), _j(keys), _j(box),
                                            _j(mask), None)
    for name, a, b in zip(("wl", "nw", "overflow"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert (int(got[2]) > 0) == (psk == 8)


def _instances(sim):
    """(name, port kernel, matching Pallas kernel, rows, wl, nw)."""
    st = sim.state
    sp = st.split
    x_ext = torch.cat([st.x, torch.full((1, 3), 1e6)])
    out = []
    for key in ("L", "Q"):
        k = key.lower()
        rows = torch.cat([x_ext[sp[f"idx_{k}"]], sp[f"props_{k}"]], 1)
        for we in (True, False):
            kern = sim._split["kernels"][we][key]
            jk = J.make_colpair_direct_fn(
                _jplan(sim._split[f"plan_{key}"]), has_alch=False, want_energy=we,
                interpret=True, triangular=True, mode=kern.cfg.mode,
                water_filter=kern.cfg.water_filter, per_slice_k=64)
            out.append((kern.name, kern, jk, rows, sp[f"wl_{k}"],
                        sp[f"nw_{k}"]))
    # the monolithic 'full' kernel on the master tables
    xs, keys, mask = _master_sorted(sim)
    rows = torch.cat([xs, sim._props_base[_master_perm(sim)]], 1)
    wl, nw, _ = T.make_window_fn(sim.plan)(xs, keys, st.box, mask)
    for we in (True, False):
        jk = J.make_colpair_direct_fn(_jplan(sim.plan), has_alch=False,
                                      want_energy=we, interpret=True,
                                      triangular=True, per_slice_k=64)
        out.append((f"master_{we}", sim._direct[we], jk, rows, wl, nw))
    return out


N_COUPLED = 10       # solute base ids 0..9 form the coupled molecule


def _alch_instances(sim):
    """(name, port has_alch kernel, matching Pallas kernel, rows, wl, nw)
    for L ('full') and Q ('coul' + water filter), force-only and energy,
    with rows col 6 (couple mask) set on the coupled solute atoms."""
    st = sim.state
    sp = st.split
    x_ext = torch.cat([st.x, torch.full((1, 3), 1e6)])
    out = {}
    for key in ("L", "Q"):
        k = key.lower()
        rows = torch.cat([x_ext[sp[f"idx_{k}"]], sp[f"props_{k}"]], 1)
        g = rows[:, 7]
        rows[:, 6] = ((g >= 1) & (g <= N_COUPLED)).to(rows.dtype)
        for we in (True, False):
            cfg = sim._split["kernels"][we][key].cfg
            plan = sim._split[f"plan_{key}"]
            kern = T.ColpairDirect(plan, want_energy=we, mode=cfg.mode,
                                   water_filter=cfg.water_filter,
                                   has_alch=True)
            jk = J.make_colpair_direct_fn(
                _jplan(plan), has_alch=True, want_energy=we, interpret=True,
                triangular=True, mode=cfg.mode,
                water_filter=cfg.water_filter, per_slice_k=64)
            out[(cfg.mode, we)] = (kern.name, kern, jk, rows, sp[f"wl_{k}"],
                                   sp[f"nw_{k}"])
    return out


def _master_perm(sim):
    xw, box = _sort_inputs(sim)
    return sim._anchor_sort(xw, box)[0]


@pytest.mark.parametrize("case", range(6))
def test_kernel_plain_matches_pallas(sim, case):
    name, kern, jk, rows, wl, nw = _instances(sim)[case]
    st = sim.state
    f, e_lj, e_c = kern(rows, rows.T.contiguous(), wl, nw, st.box,
                        st.couple)
    fr, ljr, cr = jk(_j(rows), _j(rows).T, _j(wl), _j(nw), _j(st.box),
                     jnp.float32(1.0))
    fr = np.asarray(fr, np.float32)
    assert np.abs(f.numpy() - fr).max() / np.abs(fr).max() < 1e-5, name
    for got, ref in ((e_lj, ljr), (e_c, cr)):
        ref = float(np.float32(ref))
        assert abs(float(got) - ref) <= 1e-5 * max(abs(ref), 1e-3), name
    assert np.abs(fr).max() > 0


@pytest.mark.parametrize("couple", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("we", [False, True])
@pytest.mark.parametrize("mode", ["full", "coul"])
def test_alch_kernel_plain_matches_pallas(sim, mode, we, couple):
    """K1d: the plain softcore twin against the Pallas has_alch kernel.
    At couple 1 the softcore terms vanish; 0.5 and 0.05 (lambda 0.95) are
    where soft_c and the Beutler denominator are large."""
    name, kern, jk, rows, wl, nw = _alch_instances(sim)[(mode, we)]
    assert kern.cfg.kpoly is None and "alch" in name
    assert kern.cfg.water_filter is not None or mode == "full"
    st = sim.state
    c = torch.tensor(couple, dtype=torch.float32)
    f, e_lj, e_c = kern(rows, rows.T.contiguous(), wl, nw, st.box, c)
    fr, ljr, cr = jk(_j(rows), _j(rows).T, _j(wl), _j(nw), _j(st.box),
                     jnp.float32(couple))
    fr = np.asarray(fr, np.float32)
    assert np.abs(f.numpy() - fr).max() / np.abs(fr).max() < 1e-5, name
    for got, ref in ((e_lj, ljr), (e_c, cr)):
        ref = float(np.float32(ref))
        assert abs(float(got) - ref) <= 1e-5 * max(abs(ref), 1e-3), name
    assert np.abs(fr).max() > 0
    if couple < 1.0:
        # the coupling changes the result: the softcore branch acted
        f1, _, _ = kern(rows, rows.T.contiguous(), wl, nw, st.box,
                        torch.tensor(1.0))
        assert float((f1 - f).abs().max()) > 1e-3


@pytest.mark.parametrize("we", [False, True])
@pytest.mark.parametrize("mode", ["full", "coul"])
def test_alch_plain_stats_and_float32_floor(sim, mode, we):
    """The per-site and per-cluster scales cover the softcore terms: at
    couple 0.05 the plain has_alch twin in float32 against its float64 run
    stays under the floors of the plain instances (5e-6, 2e-6), and |F|
    and |E_cluster| stay under their magnitude sums."""
    name, kern, _, rows, wl, nw = _alch_instances(sim)[(mode, we)]
    box = sim.state.box
    stats32 = {}
    f, _, _ = T.colpair_plain(rows, rows.T.contiguous(), wl, nw, box,
                              kern.cfg, 0.05, stats=stats32)
    slack = 1.0 + 1e-5
    assert bool((torch.linalg.vector_norm(f, dim=1)
                 <= stats32["f_abs"] * slack + 1e-6).all()), name
    assert bool((stats32["e_cluster"].abs()
                 <= stats32["e_abs"] * slack + 1e-6).all()), name
    r64 = rows.double()
    stats64 = {}
    f64, _, _ = T.colpair_plain(r64, r64.T.contiguous(), wl, nw,
                                box.double(), kern.cfg, 0.05, stats=stats64)
    rel_f, rel_e = T.colpair_parity(f.double(),
                                    stats32["e_cluster"].double(), f64,
                                    stats64)
    assert rel_f < 5e-6, name
    assert rel_e < 2e-6, name


@pytest.mark.parametrize("case", range(6))
def test_plain_stats_bound_the_outputs(sim, case):
    """colpair_plain's magnitude sums: |F| <= the site's sum of pair-force
    term magnitudes, the cluster energies add up to the totals (rel 1e-5,
    summation order), and |E_cluster| <= its sum of pair-energy term
    magnitudes."""
    name, kern, _, rows, wl, nw = _instances(sim)[case]
    stats = {}
    f, e_lj, e_c = T.colpair_plain(rows, rows.T.contiguous(), wl, nw,
                                   sim.state.box, kern.cfg, stats=stats)
    assert stats["pairs"] > 0
    slack = 1.0 + 1e-5
    assert bool((torch.linalg.vector_norm(f, dim=1)
                 <= stats["f_abs"] * slack + 1e-6).all()), name
    assert bool((stats["e_cluster"].abs()
                 <= stats["e_abs"] * slack + 1e-6).all()), name
    e_tot = float(e_lj + e_c)
    assert abs(float(stats["e_cluster"].sum()) - e_tot) \
        <= 1e-5 * float(stats["e_abs"].sum()) + 1e-6, name
    assert (float(stats["e_abs"].sum()) > 0) == kern.cfg.want_energy
    # a kernel that matches exactly passes with ratio 0
    assert T.colpair_parity(f, stats["e_cluster"], f, stats) == (0.0, 0.0)


@pytest.mark.parametrize("case", range(6))
def test_plain_float32_floor_per_site(sim, case):
    """The float32 floor that chip_smoke's kernel gate (1e-5 per site and
    per cluster, between two float32 evaluations) stands on: the plain
    version against its own float64 run, per site < 5e-6 and per cluster
    < 2e-6."""
    name, kern, _, rows, wl, nw = _instances(sim)[case]
    box = sim.state.box
    stats32 = {}
    f, _, _ = T.colpair_plain(rows, rows.T.contiguous(), wl, nw, box,
                              kern.cfg, stats=stats32)
    r64 = rows.double()
    stats64 = {}
    f64, _, _ = T.colpair_plain(r64, r64.T.contiguous(), wl, nw,
                                box.double(), kern.cfg, stats=stats64)
    rel_f, rel_e = T.colpair_parity(f.double(),
                                    stats32["e_cluster"].double(), f64,
                                    stats64)
    assert rel_f < 5e-6, name
    assert rel_e < 2e-6, name


@pytest.mark.parametrize("we", [False, True])
def test_parity_gate_catches_a_water_lj_error(sim, we):
    """A 1e-3 error in the LJ well depth of water O, which a limit of
    1e-4 of max|F| lets through (max|F| sits on excluded solute pairs at
    the C1 clamp), fails chip_smoke's per-site and per-cluster gate (1e-5)
    by more than 10x."""
    st = sim.state
    sp = st.split
    kern = sim._split["kernels"][we]["L"]
    wlo, whi = sim._split["kernels"][we]["Q"].cfg.water_filter
    x_ext = torch.cat([st.x, torch.full((1, 3), 1e6)])
    rows = torch.cat([x_ext[sp["idx_l"]], sp["props_l"]], 1)
    args = (sp["wl_l"], sp["nw_l"], st.box, kern.cfg)
    stats = {}
    f, _, _ = T.colpair_plain(rows, rows.T.contiguous(), *args, stats=stats)
    bad = rows.clone()
    water = (bad[:, 7] >= wlo) & (bad[:, 7] < whi)
    assert bool(water.any()) and not bool(water.all())
    bad[:, 5] = torch.where(water, bad[:, 5] * (1.0 + 1e-3), bad[:, 5])
    stats_bad = {}
    f_bad, _, _ = T.colpair_plain(bad, bad.T.contiguous(), *args,
                                  stats=stats_bad)
    assert float((f_bad - f).abs().max()) < 1e-4 * float(f.abs().max())
    rel_f, rel_e = T.colpair_parity(f_bad, stats_bad["e_cluster"], f, stats)
    assert rel_f > 1e-4
    assert (rel_e > 1e-4) == we


def test_kernel_wrapper_checks(sim):
    alch = T.ColpairDirect(sim.plan, want_energy=False, has_alch=True)
    assert alch.cfg.kpoly is None and alch.name == "colpair_full_alch_force"
    with pytest.raises(ValueError):
        T.ColpairDirect(sim.plan, want_energy=False, mode="lj",
                        has_alch=True)
    with pytest.raises(ValueError):
        T.colpair_plain(torch.zeros((sim.S, 8)), torch.zeros((8, sim.S)),
                        torch.zeros((sim.plan.n_clusters, 3),
                                    dtype=torch.int32),
                        torch.zeros((sim.plan.n_clusters,),
                                    dtype=torch.int32),
                        sim.state.box, alch.cfg)
    z = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        T._pair_tile(*([z] * 12), z > 0, 1.0, 0.3, (1.0,), False, "full",
                     ((1.0, 2.0), 3.0), alch=z)
    with pytest.raises(ValueError):
        T.ColpairDirect(sim.plan, want_energy=False, mode="bogus")
    kern = sim._direct[False]
    rows = torch.zeros((sim.S, 8))
    wl = torch.zeros((sim.plan.n_clusters, 192), dtype=torch.int32)
    nw = torch.zeros((sim.plan.n_clusters,), dtype=torch.int32)
    with pytest.raises(ValueError):
        kern(rows[:100], rows[:100].T, wl, nw, sim.state.box, 1.0)
    with pytest.raises(ValueError):
        kern(rows, rows.T, wl[:3], nw, sim.state.box, 1.0)
    f, e_lj, e_c = kern(rows, rows.T.contiguous(), wl, nw, sim.state.box,
                        1.0)
    assert float(f.abs().sum()) == 0.0 and float(e_lj) == 0.0


def test_s2_clamped_equal():
    s2 = np.linspace(0.0, 10.0, 4001).astype(np.float32)
    a, ga = T._s2_clamped(torch.tensor(s2))
    b, gb = J._s2_clamped(jnp.asarray(s2))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(gb))


@pytest.mark.parametrize("which", ["excl", "p14"])
def test_pairlist_energy_and_forces(sim, which):
    st = sim.state
    idx = st.excl_idx if which == "excl" else st.p14_idx
    mask = sim._excl_mask if which == "excl" else sim._p14_mask
    p = st.props
    args = (p[:, 0], p[:, 1], p[:, 2], p[:, 3])
    x = st.x.clone().requires_grad_(True)
    el, ec = T.pairlist_colpair_energy(x, st.box, idx, mask, *args,
                                       st.couple, sim.plan)
    (g,) = torch.autograd.grad(el + ec, x)
    el, ec = el.detach(), ec.detach()

    def ref(xx):
        a, b = J.pairlist_colpair_energy(
            xx, _j(st.box), _j(idx), _j(mask), *[_j(a) for a in args],
            jnp.float32(1.0), _jplan(sim.plan))
        return a + b, (a, b)

    (_, (elr, ecr)), gr = jax.value_and_grad(ref, has_aux=True)(_j(st.x))
    for got, r in ((el, elr), (ec, ecr)):
        r = float(np.float32(r))
        assert abs(float(got) - r) <= 1e-5 * abs(r)
    gr = np.asarray(gr, np.float32)
    assert np.abs(g.numpy() - gr).max() <= 1e-5 * np.abs(gr).max()
