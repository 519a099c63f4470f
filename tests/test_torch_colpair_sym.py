"""Port parity of colpair's symmetric table (K1e) and cross variant (K1g)
against molchanica_tpu on the CPU, with the Pallas kernel in interpret
mode, and of FastSim(triangular=False).

K1e runs on test_torch_colpair's system (the 8-residue polyalanine in a
24 A OPC box, 6 A cutoff, S = 1,920 master slots). K1g runs on 600 random
sites in a 21 x 22 x 23 A box (6 A cutoff): the first 100 are the solute
subset, sorted with the master's column grid, and the other 500 carry
group ids in the water range, so the kernel evaluates every pair that has
a solute site, once.

Tolerances: integer tables (wl, nw, overflow) exactly equal; the plain
twins against the Pallas kernels at test_torch_colpair.py's bounds (forces
max|dF|/max|F| < 1e-5, energies rel < 1e-5: float32 summation order
only); the symmetric against the triangular plain twin on one state at
the same bounds, per site within 1e-5 of the site's sum of pair-force
term magnitudes, and their float64 runs per site within 1e-9 of it (the
two tables hold the same pairs); FastSim(triangular=False) against the
JAX FastSim under MOLCHANICA_FASTSIM_TRI=0 at test_torch_fast_engine.py's
bounds (energy terms rel < 1e-5, recip 3e-5; forces within 1e-4 of the
largest force plus 2e-6 of the largest direct-space kernel force), and
against the port's split engine per site within 1e-4 of max|F| plus 1e-5
of the site's direct-space scale; the assembled cross forces
against a dense float64 sum of the same pair formula within 1e-5 of
max|F| and its energies rel < 1e-5 (float32 against float64).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.fast_engine import FastSim as JFast
from molchanica_tpu.ops.pallas import colpair as J
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.fast_engine import FastSim
from molchanica_tpu_torch.ops import colpair as T
from molchanica_tpu_torch.ops.pme import ewald_beta_for
from molchanica_tpu_torch.systems.bench_systems import build_solvated_protein
from test_torch_colpair import N_COUPLED, _j, _jplan, _master_sorted
from test_torch_colpair_range import _port_top
from test_torch_fast_engine import KW, _system

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim():
    """The port's FastSim(triangular=False) on test_torch_colpair's
    system: no species split, symmetric master tables."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=1.0),
                   lj_cutoff=6.0, coulomb_cutoff=6.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   max_init_relaxation_iters=None, seed=3)
    v0 = np.zeros(asys.positions.shape, np.float32)
    return FastSim(asys.topology, cfg, asys.positions,
                   box_extent=asys.box_extent, velocities=v0, device="cpu",
                   triangular=False)


def _master_rows(sim):
    xs, keys, mask = _master_sorted(sim)
    xw = torch.tensor(sim.positions_unsorted())
    xw = xw - sim.state.box * torch.floor(xw / sim.state.box)
    perm = sim._anchor_sort(xw, sim.state.box)[0]
    rows = torch.cat([xs, sim._props_base[perm]], 1)
    return rows, xs, keys, mask


@pytest.mark.parametrize("psk", [64, 0])
def test_sym_window_tables_equal(sim, psk):
    """Symmetric master tables, per-slice and range, equal the JAX ones
    and hold more entries than the triangular table of the same state."""
    _, xs, keys, mask = _master_rows(sim)
    box = sim.state.box
    got = T.make_window_fn(sim.plan, per_slice_k=psk, triangular=False)(
        xs, keys, box, mask)
    ref = J.make_window_fn(_jplan(sim.plan), triangular=False,
                           per_slice_k=psk)(_j(xs), _j(keys), _j(box),
                                            _j(mask), None)
    for name, a, b in zip(("wl", "nw", "overflow"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int(got[2]) == 0
    tri = T.make_window_fn(sim.plan, per_slice_k=psk)(xs, keys, box, mask)
    assert int(got[1].sum()) > int(tri[1].sum())


def _sym_case(sim, we, alch, psk):
    rows, xs, keys, mask = _master_rows(sim)
    if alch:
        g = rows[:, 7]
        rows[:, 6] = ((g >= 1) & (g <= N_COUPLED)).to(rows.dtype)
    wl, nw, ovf = T.make_window_fn(sim.plan, per_slice_k=psk,
                                   triangular=False)(xs, keys, sim.state.box,
                                                     mask)
    assert int(ovf) == 0
    kern = T.ColpairDirect(sim.plan, want_energy=we, has_alch=alch,
                           range_tables=psk == 0, triangular=False)
    return kern, rows, wl, nw


@pytest.mark.parametrize("psk", [64, 0])
@pytest.mark.parametrize("alch,couple", [(False, 1.0), (True, 0.5)])
@pytest.mark.parametrize("we", [False, True])
def test_sym_kernel_plain_matches_pallas(sim, we, alch, couple, psk):
    """K1e: force-only (K-poly) and energy, plain and has_alch, per-slice
    and range tables."""
    kern, rows, wl, nw = _sym_case(sim, we, alch, psk)
    assert "_sym_" in kern.name and kern.cfg.triangular is False
    jk = J.make_colpair_direct_fn(_jplan(sim.plan), has_alch=alch,
                                  want_energy=we, interpret=True,
                                  triangular=False, per_slice_k=psk)
    box = sim.state.box
    c = torch.tensor(couple, dtype=torch.float32)
    f, e_lj, e_c = kern(rows, rows.T.contiguous(), wl, nw, box, c)
    fr, ljr, cr = jk(_j(rows), _j(rows).T, _j(wl), _j(nw), _j(box),
                     jnp.float32(couple))
    fr = np.asarray(fr, np.float32)
    assert np.abs(f.numpy() - fr).max() / np.abs(fr).max() < 1e-5, kern.name
    for got, ref in ((e_lj, ljr), (e_c, cr)):
        ref = float(np.float32(ref))
        assert abs(float(got) - ref) <= 1e-5 * max(abs(ref), 1e-3), kern.name
    assert np.abs(fr).max() > 0 and (not we or float(e_lj) != 0.0)


@pytest.mark.parametrize("we", [False, True])
def test_sym_matches_triangular(sim, we):
    """The symmetric plain twin on the symmetric table against the
    triangular one on the triangular table of the same state (what
    scripts/check_triangular.py compares on the chip), with the per-site
    scale of the symmetric stats (every site carries all of its pairs as
    an i row there)."""
    rows, xs, keys, mask = _master_rows(sim)
    box = sim.state.box
    pT = rows.T.contiguous()
    stats = {}
    wl_s, nw_s, _ = T.make_window_fn(sim.plan, triangular=False)(
        xs, keys, box, mask)
    fs, ljs, cs = T.colpair_plain(
        rows, pT, wl_s, nw_s, box,
        T.ColpairDirect(sim.plan, we, triangular=False).cfg, stats=stats)
    wl_t, nw_t, _ = T.make_window_fn(sim.plan)(xs, keys, box, mask)
    ft, ljt, ct = T.colpair_plain(rows, pT, wl_t, nw_t, box,
                                  T.ColpairDirect(sim.plan, we).cfg)
    assert float((fs - ft).abs().max()) < 1e-5 * float(ft.abs().max())
    rel_f, _ = T.colpair_parity(fs, stats["e_cluster"], ft, stats)
    assert rel_f < 1e-5
    # the same pairs: the float64 sums of the two tables agree per site to
    # float64 roundoff
    r64 = rows.double()
    f64 = [T.colpair_plain(r64, r64.T.contiguous(), wl, nw, box.double(),
                           T.ColpairDirect(sim.plan, we,
                                           triangular=tri).cfg)[0]
           for wl, nw, tri in ((wl_s, nw_s, False), (wl_t, nw_t, True))]
    err64 = (f64[0] - f64[1]).abs().amax(dim=1)
    assert float((err64 / stats["f_abs"].double().clamp_min(1e-30)).max()) \
        < 1e-9
    if we:
        for a, b in ((ljs, ljt), (cs, ct)):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        assert abs(float(stats["e_cluster"].sum()) - float(ljs + cs)) \
            <= 1e-5 * float(stats["e_abs"].sum())


@pytest.mark.parametrize("site", ["solute", "water"])
def test_sym_gate_sees_faults(sim, site, monkeypatch):
    """chip_smoke.py's gate across the two tables (per site, SYM_TOL_F of
    the symmetric run's pair-term magnitudes) passes the symmetric against
    the triangular plain twin and fails both faults its phase 18 injects:
    the own-slot entries of one cluster (holding a solute or a water site)
    emptied, and water O's LJ well depth off by 1e-3. The kernel launch is
    the plain twin here."""
    import chip_smoke

    rows, xs, keys, mask = _master_rows(sim)
    box = sim.state.box
    pT = rows.T.contiguous()
    wl_s, nw_s, _ = T.make_window_fn(sim.plan, triangular=False)(
        xs, keys, box, mask)
    wl_t, nw_t, _ = T.make_window_fn(sim.plan)(xs, keys, box, mask)
    kern = T.ColpairDirect(sim.plan, False, triangular=False)
    stats = {}
    fs = T.colpair_plain(rows, pT, wl_s, nw_s, box, kern.cfg,
                         stats=stats)[0]
    ft = T.colpair_plain(rows, pT, wl_t, nw_t, box,
                         T.ColpairDirect(sim.plan, False).cfg)[0]
    assert T.colpair_parity(fs, stats["e_cluster"], ft, stats)[0] \
        < chip_smoke.SYM_TOL_F
    g = rows[:, 7]
    in_w = (g >= sim._ws + 1) & (g < sim._ws + sim._n_wsites + 1)
    pick = in_w if site == "water" else (g > 0) & ~in_w
    c = int(torch.nonzero(pick)[0, 0]) // T.ICL

    def plain_launch(cfg, r, p, wl, nw, b, params, couple=None):
        f = T.colpair_plain(r, p, wl, nw, b, cfg, couple)[0]
        return f, torch.zeros((r.shape[0] // T.ICL, 2))

    monkeypatch.setattr(T, "colpair_cuda", plain_launch)
    faults = chip_smoke.sym_fault_ratios(sim, rows, wl_s, nw_s, kern, ft,
                                         stats, c, torch)
    assert len(faults) == 2
    assert all(v > chip_smoke.SYM_TOL_F for v in faults.values()), faults


def test_sym_instances_and_checks(sim):
    names = {k.name for k in sim._direct.values()}
    assert names == {"colpair_full_sym_force", "colpair_full_sym_energy"}
    assert sim._split is None and sim.state.wl is not None
    with pytest.raises(ValueError, match="ROADMAP"):
        T.ColpairDirect(sim.plan, False, mode="coul", triangular=False)
    with pytest.raises(ValueError, match="ROADMAP"):
        T.ColpairDirect(sim.plan, False, triangular=False,
                        water_filter=(1.0, 2.0))
    with pytest.raises(ValueError, match="ROADMAP"):
        T.ColpairDirect(sim.plan, False, has_alch=True,
                        cross=(1.0, 2.0, sim.S))


# ---------------------------------------------------------------------------
# FastSim(triangular=False) against the JAX FastSim under
# MOLCHANICA_FASTSIM_TRI=0
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_sym():
    asys, v0 = _system()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOLCHANICA_FASTSIM_TRI", "0")
        js = JFast(asys.topology,
                   JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                        hydrogen_constraint=JH.shake(), **KW),
                   asys.positions, box_extent=asys.box_extent,
                   velocities=v0)
        ts = FastSim(_port_top(asys), MdConfig(
            integrator=Integrator.langevin_middle(gamma=0.0),
            hydrogen_constraint=HydrogenConstraint.shake(), **KW),
            asys.positions, box_extent=asys.box_extent, velocities=v0,
            device="cpu")
    return js, ts


def test_fastsim_sym_tables_equal(pair_sym):
    js, ts = pair_sym
    assert js._split is None and ts._split is None and ts._tri is False
    for key in ("perm", "wl", "nw"):
        np.testing.assert_array_equal(np.asarray(getattr(js.state, key)),
                                      getattr(ts.state, key).numpy(),
                                      err_msg=key)


def test_fastsim_sym_force_and_energy_terms(pair_sym):
    js, ts = pair_sym
    st = js.state
    force_j = js._make_force_fn(None, want_energy=True)
    fj, (ej, tj) = jax.jit(lambda x, s: force_j(x, s))(st.x, st)
    tst = ts.state.replace(x=torch.tensor(np.asarray(st.x)))
    with torch.no_grad():
        ft, (et, tt) = ts._make_force_fn(True)(tst.x, tst)
        rows = torch.cat([tst.x, tst.props], 1)
        f_dir, _, _ = ts._direct[False](rows, rows.T.contiguous(), tst.wl,
                                        tst.nw, tst.box, tst.couple)
    for k, ref in tj.items():
        if k in ("energy_potential", "energy_potential_nonbonded"):
            continue
        ref = float(np.float32(ref))
        tol = 3e-5 if k == "recip" else 1e-5
        assert abs(float(tt[k]) - ref) <= tol * abs(ref), k
    fj = np.asarray(fj, np.float32)
    err = np.abs(ft.numpy() - fj).max()
    assert err <= 1e-4 * np.abs(fj).max() + 2e-6 * float(f_dir.abs().max())
    assert np.abs(fj).max() > 10.0


def test_fastsim_sym_matches_split_engine(pair_sym):
    """The symmetric engine against the default species-split engine of
    the port on one state (chip_smoke's card check, on the CPU): forces
    per site within 1e-4 of max|F| plus 1e-5 of the site's direct-space
    scale, energy terms rel < 1e-5."""
    _, ts = pair_sym
    asys, v0 = _system()
    split = FastSim(ts.top, ts.cfg, asys.positions,
                    box_extent=asys.box_extent, velocities=v0, device="cpu",
                    triangular=True)
    assert split._split is not None
    assert torch.equal(split.state.perm, ts.state.perm)
    st = ts.state
    with torch.no_grad():
        rows = torch.cat([ts._apply_vsites(st.x, st, st.box),
                          st.props], 1)
        stats = {}
        T.colpair_plain(rows, rows.T.contiguous(), st.wl, st.nw, st.box,
                        ts._direct[False].cfg, stats=stats)
        a = ts._spread_vsite_forces(stats["f_abs"][:, None].repeat(1, 3),
                                    st)[:, 0]
        st_p = split.state.replace(x=st.x)
        for we in (False, True):
            fs, (_, tsym) = ts._make_force_fn(we)(st.x, st)
            fp, (_, tspl) = split._make_force_fn(we)(st_p.x, st_p)
            err = (fs - fp).abs().amax(dim=1)
            tol = 1e-4 * float(fp.abs().max()) + 1e-5 * a
            assert bool((err <= tol).all())
            for k in ("bond", "angle", "dihedral", "recip") + (
                    ("lj", "coulomb") if we else ()):
                ref = float(tspl[k])
                assert abs(float(tsym[k]) - ref) <= 1e-5 * abs(ref), k


def test_fastsim_tri_knob_and_replan(pair_sym):
    """MOLCHANICA_FASTSIM_TRI=0 selected the symmetric engine above; a
    replan keeps it, and one period steps on it."""
    _, ts = pair_sym
    sim = FastSim(ts.top, ts.cfg, ts.positions_unsorted(),
                  box_extent=ts.state.box.numpy(),
                  velocities=ts.velocities_unsorted(), device="cpu",
                  triangular=False)
    sim._replan(per_slice_k=32)
    assert sim._tri is False and sim._split is None and sim._psk == 32
    evals = sim.force_evals
    sim.step(0.002, 4)
    assert sim.step_count == 4 and sim.force_evals == evals + 4
    assert np.isfinite(sim.positions_unsorted()).all()


# ---------------------------------------------------------------------------
# K1g: the cross variant
# ---------------------------------------------------------------------------

N_CROSS, N_SOLUTE, N_BASE = 600, 100, 640


@pytest.fixture(scope="module")
def cross_case():
    """Master and solute-subset sorts of 600 random sites (per-site sort,
    the master's column grid), their rows, and the water gid range."""
    rng = np.random.default_rng(11)
    box = np.array([21.0, 22.0, 23.0], np.float32)
    x = (rng.uniform(0, 1, (N_BASE, 3)) * box).astype(np.float32)
    x[N_CROSS:] = 0.0
    mask = (np.arange(N_BASE) < N_CROSS).astype(np.float32)
    props = np.stack([rng.normal(0, 3.0, N_BASE),
                      rng.uniform(1.3, 1.7, N_BASE),
                      rng.uniform(0.3, 0.9, N_BASE), np.zeros(N_BASE),
                      (np.arange(N_BASE) + 1.0) * mask], 1).astype(np.float32)
    plan = T.plan_columns(box, 6.0, ewald_beta_for(6.0, 1e-5), N_CROSS,
                          N_BASE, skin=0.5)
    cap = N_SOLUTE + T.ICL * plan.n_cols
    plan_sub = dataclasses.replace(plan, n_sorted=((cap + 127) // 128) * 128,
                                   n_base=N_SOLUTE)
    bt = torch.tensor(box)

    def sorted_rows(p, xb, pb, mb):
        perm, keys, _, ovf = T.make_sort_fn(p)(torch.tensor(xb), bt,
                                               torch.tensor(mb))
        assert int(ovf) == 0
        xw = torch.tensor(xb) - bt * torch.floor(torch.tensor(xb) / bt)
        xs = torch.cat([xw, torch.full((1, 3), 1e6)])[perm]
        pr = torch.cat([torch.tensor(pb), torch.zeros((1, 5))])[perm]
        return perm, keys, torch.cat([xs, pr], 1)

    perm_m, keys_m, rows_m = sorted_rows(plan, x, props, mask)
    perm_s, keys_s, rows_s = sorted_rows(plan_sub, x[:N_SOLUTE],
                                         props[:N_SOLUTE],
                                         np.ones(N_SOLUTE, np.float32))
    wrange = (float(N_SOLUTE + 1), float(N_CROSS + 1))
    return dict(plan=plan, plan_sub=plan_sub, box=bt, x=x, props=props,
                perm_m=perm_m, keys_m=keys_m, rows_m=rows_m, perm_s=perm_s,
                keys_s=keys_s, rows_s=rows_s, wrange=wrange)


def _cross_windows(c, psk):
    rs, rm = c["rows_s"], c["rows_m"]
    got = T.make_window_fn(c["plan_sub"], per_slice_k=psk,
                           cross_j_size=rm.shape[0])(
        rs[:, :3], c["keys_s"], c["box"], rs[:, 7], c["keys_m"], rm[:, 7])
    ref = J.make_window_fn(_jplan(c["plan_sub"]), cross_j_size=rm.shape[0],
                           per_slice_k=psk)(
        _j(rs[:, :3]), _j(c["keys_s"]), _j(c["box"]), _j(rs[:, 7]), None,
        _j(c["keys_m"]), _j(rm[:, 7]))
    return got, ref


@pytest.mark.parametrize("psk", [64, 0])
def test_cross_windows_equal(cross_case, psk):
    got, ref = _cross_windows(cross_case, psk)
    for name, a, b in zip(("wl", "nw", "overflow"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int(got[2]) == 0 and int(got[1].max()) > 0
    with pytest.raises(ValueError):
        T.make_window_fn(cross_case["plan_sub"], cross_j_size=17)(
            cross_case["rows_s"][:, :3], cross_case["keys_s"],
            cross_case["box"], cross_case["rows_s"][:, 7])


def _cross_kernel(c, we, psk):
    wlo, whi = c["wrange"]
    s_j = c["rows_m"].shape[0]
    return T.ColpairDirect(c["plan_sub"], want_energy=we,
                           range_tables=psk == 0, cross=(wlo, whi, s_j))


@pytest.mark.parametrize("psk", [64, 0])
@pytest.mark.parametrize("we", [False, True])
def test_cross_plain_matches_pallas(cross_case, we, psk):
    """K1g: i-forces over the subset and reactions over the master against
    the JAX cross factory, force-only (K-poly) and energy."""
    c = cross_case
    (wl, nw, _), _ = _cross_windows(c, psk)
    kern = _cross_kernel(c, we, psk)
    assert "_cross_" in kern.name
    rs, pT = c["rows_s"], c["rows_m"].T.contiguous()
    f_i, f_j, e_lj, e_c = kern(rs, pT, wl, nw, c["box"], 1.0)
    wlo, whi = c["wrange"]
    jk = J.make_colpair_direct_fn(
        _jplan(c["plan_sub"]), has_alch=False, want_energy=we,
        interpret=True, cross=(wlo, whi, pT.shape[1]), per_slice_k=psk)
    ri, rj, ljr, cr = jk(_j(rs), _j(pT), _j(wl), _j(nw), _j(c["box"]),
                         jnp.float32(1.0))
    scale = max(np.abs(np.asarray(ri)).max(), np.abs(np.asarray(rj)).max())
    assert np.abs(f_i.numpy() - np.asarray(ri, np.float32)).max() \
        < 1e-5 * scale
    assert np.abs(f_j.numpy() - np.asarray(rj, np.float32)).max() \
        < 1e-5 * scale
    for got, ref in ((e_lj, ljr), (e_c, cr)):
        ref = float(np.float32(ref))
        assert abs(float(got) - ref) <= 1e-5 * max(abs(ref), 1e-3)
    assert scale > 0


def _dense_cross(c):
    """(force [600, 3], e_lj, e_c) in float64 over every pair with a
    solute site, by the kernel's pair formula (`_pair_tile`, erfcx
    Coulomb) on minimum-image displacements. Its force is the kernel's
    (dV/dr2 at the clamped r^2 times the true displacement), not the
    gradient of the clamped energy, which vanishes below R2_MIN."""
    from molchanica_tpu_torch.ops.pbc import minimum_image

    a, b = np.triu_indices(N_CROSS, 1)
    keep = a < N_SOLUTE
    a, b = torch.tensor(a[keep]), torch.tensor(b[keep])
    x = torch.tensor(c["x"][:N_CROSS], dtype=torch.float64)
    p = torch.tensor(c["props"][:N_CROSS], dtype=torch.float64)
    d = minimum_image(x[a] - x[b], c["box"].double())
    zero = torch.zeros_like(d[:, 0])
    plan = c["plan"]
    coeff, el, ec, dx, dy, dz, _ = T._pair_tile(
        d[:, 0], d[:, 1], d[:, 2], p[a, 0], p[a, 1], p[a, 2], zero, zero,
        zero, p[b, 0], p[b, 1], p[b, 2], torch.ones_like(zero, dtype=bool),
        plan.cutoff ** 2, plan.beta, plan.erfcx_coeffs, True, "full", None,
        self_guard=True)
    fp = 2.0 * coeff[:, None] * torch.stack([dx, dy, dz], 1)
    f = torch.zeros_like(x).index_add_(0, a, -fp).index_add_(0, b, fp)
    return f, float(el.sum()), float(ec.sum())


@pytest.mark.parametrize("we", [False, True])
def test_cross_matches_dense(cross_case, we):
    """f_i + f_j, assembled in base order, against the dense sum of every
    pair with a solute site (each counted once: water j always kept,
    solute j only above the i's group id)."""
    c = cross_case
    (wl, nw, _), _ = _cross_windows(c, 64)
    f_i, f_j, e_lj, e_c = _cross_kernel(c, we, 64)(
        c["rows_s"], c["rows_m"].T.contiguous(), wl, nw, c["box"], 1.0)
    f = torch.zeros((N_BASE + 1, 3))
    f.index_add_(0, c["perm_m"], f_j)
    f.index_add_(0, torch.where(c["perm_s"] < N_SOLUTE, c["perm_s"],
                                torch.full_like(c["perm_s"], N_BASE)), f_i)
    f_ref, el_ref, ec_ref = _dense_cross(c)
    f_ref = f_ref.float()
    assert float((f[:N_CROSS] - f_ref).abs().max()) \
        < 1e-5 * float(f_ref.abs().max())
    assert float(f[N_CROSS:N_BASE].abs().max()) == 0.0
    if we:
        assert abs(float(e_lj) - el_ref) <= 1e-5 * abs(el_ref)
        assert abs(float(e_c) - ec_ref) <= 1e-5 * abs(ec_ref)
