"""Port parity of colpair's range tables (per_slice_k = 0), the per-site
sort and FastSim(per_slice_k=0) against molchanica_tpu on the CPU, with
the Pallas kernel in interpret mode.

Tolerances: every integer table (perm, keys, col_start, wl, nw, overflow)
exactly equal; the plain twin on range tables against the Pallas range
kernel at test_torch_colpair.py's bounds (forces max|dF|/max|F| < 1e-5,
energies rel < 1e-5: float32 summation order only); the plain twin on a
range table against itself on the per-slice table of the same state at
the same bounds; FastSim(per_slice_k=0) at test_torch_fast_engine.py's
bounds (energy terms rel < 1e-5, recip 3e-5; forces within 1e-4 of the
largest force plus 2e-6 of the largest direct-space kernel force).
"""
import jax
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
from molchanica_tpu_torch.md.fast_engine import ColpairOverflowError, FastSim
from molchanica_tpu_torch.ops import colpair as T
from molchanica_tpu_torch.ops.pme import ewald_beta_for
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)
from test_torch_colpair import N_COUPLED, _j, _jplan
from test_torch_fast_engine import KW, _system

torch.set_num_threads(1)


def _port_top(asys):
    jt = asys.topology
    return topology_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS},
        {s: getattr(jt, s) for s in STATIC_FIELDS})


@pytest.fixture(scope="module")
def pair0():
    """(reference, port) FastSim(per_slice_k=0) on test_torch_fast_engine's
    water box, from the same positions and velocities."""
    asys, v0 = _system()
    js = JFast(asys.topology,
               JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                    hydrogen_constraint=JH.shake(), **KW),
               asys.positions, box_extent=asys.box_extent, velocities=v0,
               per_slice_k=0)
    ts = FastSim(_port_top(asys), MdConfig(
        integrator=Integrator.langevin_middle(gamma=0.0),
        hydrogen_constraint=HydrogenConstraint.shake(), **KW),
        asys.positions, box_extent=asys.box_extent, velocities=v0,
        per_slice_k=0, device="cpu")
    return js, ts


def _random_system(n=600, n_base=640, seed=11):
    rng = np.random.default_rng(seed)
    box = np.array([21.0, 22.0, 23.0])
    x = rng.uniform(0, 1, (n_base, 3)) * box
    x[n:] = 0.0
    mask = (np.arange(n_base) < n).astype(np.float32)
    plan = T.plan_columns(box, 6.0, ewald_beta_for(6.0, 1e-5), n, n_base,
                          skin=0.5)
    return x.astype(np.float32), mask, box.astype(np.float32), plan


@pytest.mark.parametrize("jitter", [0.0, 0.4])
def test_per_site_sort_equal(jitter):
    x, mask, box, plan = _random_system()
    rng = np.random.default_rng(3)
    # sites outside the box and on shared keys
    x = x + rng.normal(0, jitter, x.shape).astype(np.float32)
    x[5] = x[6]
    got = T.make_sort_fn(plan)(torch.tensor(x), torch.tensor(box),
                               torch.tensor(mask))
    ref = J.make_sort_fn(_jplan(plan))(_j(torch.tensor(x)),
                                       _j(torch.tensor(box)),
                                       _j(torch.tensor(mask)))
    for name, a, b in zip(("perm", "keys", "col_start", "overflow"),
                          got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int((got[0] < plan.n_base).sum()) == int(mask.sum())


def _per_site_state(x, mask, box, plan):
    """(sorted xs, keys, mask) of the per-site sort."""
    perm, keys, _, ovf = T.make_sort_fn(plan)(
        torch.tensor(x), torch.tensor(box), torch.tensor(mask))
    assert int(ovf) == 0
    xw = torch.tensor(x) - torch.tensor(box) * torch.floor(
        torch.tensor(x) / torch.tensor(box))
    xs = torch.cat([xw, torch.full((1, 3), 1e6)])[perm]
    ms = torch.cat([torch.tensor(mask), torch.zeros(1)])[perm]
    return xs, keys, ms


def test_range_tables_equal_per_site_sort():
    x, mask, box, plan = _random_system()
    xs, keys, ms = _per_site_state(x, mask, box, plan)
    bt = torch.tensor(box)
    got = T.make_window_fn(plan, per_slice_k=0)(xs, keys, bt, ms)
    ref = J.make_window_fn(_jplan(plan), triangular=True, per_slice_k=0)(
        _j(xs), _j(keys), _j(bt), _j(ms), None)
    for name, a, b in zip(("wl", "nw", "overflow"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert got[0].shape == (plan.n_clusters, 3 * plan.w_max)
    # ranges that span more than one slice: the loop the kernel runs
    w3 = got[0].reshape(plan.n_clusters, -1, 3).long()
    assert bool((((w3[..., 1] + 127) >> 7) - (w3[..., 0] >> 7) > 1).any())


@pytest.mark.parametrize("key", ["wl_l", "nw_l", "wl_q", "nw_q", "idx_l",
                                 "idx_q", "gsrc_l", "gsrc_q"])
def test_fastsim_psk0_tables_equal(pair0, key):
    js, ts = pair0
    np.testing.assert_array_equal(np.asarray(js.state.split[key]),
                                  ts.state.split[key].numpy(), err_msg=key)


def test_fastsim_psk0_builds_range_tables(pair0):
    js, ts = pair0
    assert ts._psk == js._psk == 0
    for key, plan in (("l", ts._split["plan_L"]), ("q", ts._split["plan_Q"])):
        assert ts.state.split[f"wl_{key}"].shape[1] == 3 * plan.w_max
    names = {k.name for ks in ts._split["kernels"].values()
             for k in ks.values()}
    assert names == {"colpair_full_range_force", "colpair_full_range_energy",
                     "colpair_coul_wf_range_force",
                     "colpair_coul_wf_range_energy"}


def test_fastsim_psk0_force_and_energy_terms(pair0):
    js, ts = pair0
    st = js.state
    force_j = js._make_force_fn(None, want_energy=True)
    fj, (ej, tj) = jax.jit(lambda x, s: force_j(x, s))(st.x, st)
    tst = ts.state.replace(x=torch.tensor(np.asarray(st.x)))
    with torch.no_grad():
        ft, (et, tt) = ts._make_force_fn(True)(tst.x, tst)
        sp = tst.split
        x_ext = torch.cat([tst.x, torch.full((1, 3), 1e6)])
        rows = torch.cat([x_ext[sp["idx_l"]], sp["props_l"]], 1)
        f_dir, _, _ = ts._split["kernels"][False]["L"](
            rows, rows.T.contiguous(), sp["wl_l"], sp["nw_l"], tst.box,
            tst.couple)
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


def test_fastsim_psk0_steps_and_raises_on_window_overflow(pair0):
    """A period on range tables, then a window overflow: the reference
    raises instead of widening, and so does the port, with the state of
    the last good period restored."""
    _, ts = pair0
    sim = FastSim(ts.top, ts.cfg, ts.positions_unsorted(),
                  box_extent=ts.state.box.numpy(),
                  velocities=ts.velocities_unsorted(), per_slice_k=0,
                  device="cpu")
    sim.step(0.002, 4)
    assert sim.step_count == 4 and sim._psk == 0
    win = sim._split["win_Q"]

    def overflowing(*a):
        wl, nw, _ = win(*a)
        return wl, nw, torch.ones((), dtype=torch.int64)

    sim._split["win_Q"] = overflowing
    good = sim.state
    with pytest.raises(ColpairOverflowError):
        sim.step(0.002, 4)
    assert sim.state.step == 4 and sim._psk == 0
    assert torch.equal(sim.state.x, good.x)
    with pytest.raises(ColpairOverflowError):
        sim.minimize(4)


@pytest.fixture(scope="module")
def sim0():
    """The port's FastSim(per_slice_k=0) on test_torch_colpair's system."""
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=1.0),
                   lj_cutoff=6.0, coulomb_cutoff=6.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   max_init_relaxation_iters=None, seed=3)
    v0 = np.zeros(asys.positions.shape, np.float32)
    return FastSim(asys.topology, cfg, asys.positions,
                   box_extent=asys.box_extent, velocities=v0,
                   per_slice_k=0, device="cpu")


def _range_case(sim, key, we, alch):
    """(port kernel, Pallas range kernel, rows, wl, nw) for subset `key`
    ("L", "Q") or "master" (the monolithic 'full' kernel on the master
    range table); with `alch` the first N_COUPLED solute atoms coupled."""
    st = sim.state
    x_ext = torch.cat([st.x, torch.full((1, 3), 1e6)])
    if key == "master":
        xw = torch.tensor(sim.positions_unsorted())
        xw = xw - st.box * torch.floor(xw / st.box)
        perm, keys, _, _ = sim._anchor_sort(xw, st.box)
        xs = torch.cat([xw, torch.full((1, 3), 1e6)])[perm]
        rows = torch.cat([xs, sim._props_base[perm]], 1)
        wl, nw, ovf = T.make_window_fn(sim.plan, per_slice_k=0)(
            xs, keys, st.box, rows[:, 7])
        assert int(ovf) == 0
        plan, mode, wf = sim.plan, "full", None
    else:
        k = key.lower()
        rows = torch.cat([x_ext[st.split[f"idx_{k}"]],
                          st.split[f"props_{k}"]], 1)
        wl, nw = st.split[f"wl_{k}"], st.split[f"nw_{k}"]
        cfg = sim._split["kernels"][we][key].cfg
        plan, mode, wf = sim._split[f"plan_{key}"], cfg.mode, \
            cfg.water_filter
    if alch:
        rows = rows.clone()
        g = rows[:, 7]
        rows[:, 6] = ((g >= 1) & (g <= N_COUPLED)).to(rows.dtype)
    kern = T.ColpairDirect(plan, want_energy=we, mode=mode, water_filter=wf,
                           has_alch=alch, range_tables=True)
    jk = J.make_colpair_direct_fn(_jplan(plan), has_alch=alch,
                                  want_energy=we, interpret=True,
                                  triangular=True, mode=mode,
                                  water_filter=wf, per_slice_k=0)
    return kern, jk, rows, wl, nw


@pytest.mark.parametrize("alch,couple", [(False, 1.0), (True, 0.5)])
@pytest.mark.parametrize("we", [False, True])
@pytest.mark.parametrize("key", ["L", "Q", "master"])
def test_range_kernel_plain_matches_pallas(sim0, key, we, alch, couple):
    """K1c: every mode (L 'full', Q 'coul' with the water filter, the
    monolithic 'full'), force-only (K-poly) and energy, plain and
    has_alch, on range tables."""
    kern, jk, rows, wl, nw = _range_case(sim0, key, we, alch)
    assert "range" in kern.name and wl.shape[1] == 3 * kern.w_ent
    box = sim0.state.box
    c = torch.tensor(couple, dtype=torch.float32)
    f, e_lj, e_c = kern(rows, rows.T.contiguous(), wl, nw, box, c)
    fr, ljr, cr = jk(_j(rows), _j(rows).T, _j(wl), _j(nw), _j(box),
                     np.float32(couple))
    fr = np.asarray(fr, np.float32)
    assert np.abs(f.numpy() - fr).max() / np.abs(fr).max() < 1e-5, kern.name
    for got, ref in ((e_lj, ljr), (e_c, cr)):
        ref = float(np.float32(ref))
        assert abs(float(got) - ref) <= 1e-5 * max(abs(ref), 1e-3), kern.name
    assert np.abs(fr).max() > 0


@pytest.mark.parametrize("we", [False, True])
def test_range_and_per_slice_tables_agree(we):
    """The plain twin on the range table and on the per-slice table of the
    same per-site sorted state (the kernel walks each range's slices)."""
    x, mask, box, plan = _random_system()
    xs, keys, ms = _per_site_state(x, mask, box, plan)
    rng = np.random.default_rng(4)
    n = xs.shape[0]
    props = torch.tensor(np.stack([
        rng.normal(0, 3.0, n), rng.uniform(1.3, 1.7, n),
        rng.uniform(0.3, 0.9, n), np.zeros(n)], 1), dtype=torch.float32)
    gid = torch.where(ms > 0, torch.arange(1, n + 1, dtype=torch.float32),
                      torch.zeros(n))
    rows = torch.cat([xs, props, gid[:, None]], 1)
    bt = torch.tensor(box)
    kr = T.ColpairDirect(plan, want_energy=we, range_tables=True)
    ks = T.ColpairDirect(plan, want_energy=we)
    wl_r, nw_r, _ = T.make_window_fn(plan, per_slice_k=0)(xs, keys, bt, ms)
    wl_s, nw_s, ovf = T.make_window_fn(plan)(xs, keys, bt, ms)
    assert int(ovf) == 0 and int(nw_s.max()) > int(nw_r.max())
    fr, ljr, cr = kr(rows, rows.T.contiguous(), wl_r, nw_r, bt, 1.0)
    fs, ljs, cs = ks(rows, rows.T.contiguous(), wl_s, nw_s, bt, 1.0)
    assert float((fr - fs).abs().max()) < 1e-5 * float(fs.abs().max())
    for a, b in ((ljr, ljs), (cr, cs)):
        assert abs(float(a) - float(b)) <= 1e-5 * max(abs(float(b)), 1e-3)
    assert float(fs.abs().max()) > 0
    with pytest.raises(ValueError):
        kr(rows, rows.T.contiguous(), wl_s, nw_s, bt, 1.0)
