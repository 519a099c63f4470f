"""Port parity: the cell-grid direct-space path (molchanica_tpu_torch.ops.
direct_force) against molchanica_tpu.ops.pallas.direct_force on the CPU,
on the solvated 8-residue polyalanine in a 24 A OPC box at a 6 A cutoff
(1,312 sites, 4x4x4 cells of capacity 128). The reference kernel runs in
interpret mode; its center rows, ghost array and per-slot output are
captured at its pallas_call.

The port leaves the excluded and 1-4 pairs out of the direct space
(ops/exclusions.py); the reference adds them and subtracts them again in
its rest energy with `pairlist_kernel_formula_energy`. So the port's plain
kernel with an empty exclusion table (`Exclusions.empty`) is held to the
Pallas kernel, and with the topology's table to the Pallas kernel less the
reference's own subtraction (its energies and, by jax.grad, its forces).

Tolerances: the plan, the rebuild (slot_atom, inv_slot, overflow) and the
wrapped center rows exactly equal (column 7 carries the site index + 1
where the reference's carries 1); the ghost array within 1e-6 A; the
plain kernel against the Pallas kernel (less its subtraction) per slot and
per cell under 1e-5 of the plain version's term-magnitude scales without
the table (`direct_force_parity`: the reference's float32 residue of the
excluded pairs' ~1e5 kcal/mol/A lies at that scale), total energies rel
1e-5 of the same scales.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import molchanica_tpu.ops.pallas.direct_force as DF
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.ops import direct_force as T
from molchanica_tpu_torch.ops.exclusions import (Exclusions,
                                                 exclusion_pairs,
                                                 exclusion_table)
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)

torch.set_num_threads(1)
RC = 6.0
BETA = 0.52
SHIFT = np.array([1.0, -2.0, 3.0], np.float32)


@pytest.fixture(scope="module")
def system():
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    jt = asys.topology
    tt = topology_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS},
        {s: getattr(jt, s) for s in STATIC_FIELDS})
    x = np.asarray(asys.positions, np.float32)
    box = np.asarray(asys.box_extent, np.float32)
    args = (box, RC, jt.n_atoms_real, jt.n_atoms)
    jplan = DF.plan_window(*args, x0=x)
    tplan = T.plan_window(*args, x0=x)
    return jt, tt, x, box, jplan, tplan


def _jrebuild(jt, plan, x, box):
    return [np.asarray(a) for a in jax.jit(DF.make_rebuild_fn(
        plan, jt.atom_mask))(jnp.asarray(x), jnp.asarray(box))]


def _trebuild(tt, plan, x, box):
    return [a.numpy() for a in T.make_rebuild_fn(plan, tt.atom_mask)(
        torch.tensor(x), torch.tensor(box))]


class _Capture:
    """Stands in for `pl` inside the reference module: records the
    arguments and the output of its pallas_call."""

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *a, **kw):
        call = pl.pallas_call(*a, **kw)

        def run(*args):
            self.args = [np.asarray(v) for v in args]
            self.out = np.asarray(call(*args))
            return self.out
        return run


def _reference_call(monkeypatch, jt, plan, x, box, beta=BETA):
    """The reference direct() in interpret mode: its pallas_call inputs
    and output, and its (F, e_lj, e_c)."""
    cap = _Capture()
    monkeypatch.setattr(DF, "pl", cap)
    fn = DF.make_pallas_direct_fn(jt, JCfg(lj_cutoff=RC, coulomb_cutoff=RC),
                                  plan, interpret=True)
    sa, inv, _ = jax.jit(DF.make_rebuild_fn(plan, jt.atom_mask))(
        jnp.asarray(x), jnp.asarray(box))
    F, e_lj, e_c, _ = fn(jnp.asarray(x), jnp.asarray(box),
                         jnp.asarray(1.0, jnp.float32), beta, sa, inv)
    return cap, np.asarray(F, np.float32), float(e_lj), float(e_c)


@pytest.mark.parametrize("case", ["system", "dense", "small_box"])
def test_plan_window_equal(system, case):
    jt, _, x, box, jplan, tplan = system
    if case == "system":
        assert tplan == T.WindowPlan(**dataclasses.asdict(jplan))
        assert (tplan.nc, tplan.capacity, tplan.halo) == ((4, 4, 4), 128, 1)
        return
    args = (box, RC, jt.n_atoms_real, jt.n_atoms)
    kw = dict(x0=x)
    if case == "dense":
        # 240 atoms in one cell: more than capacity 256 allows with
        # headroom, so both plans refuse
        xd = x.copy()
        xd[:240] = 1.0 + 0.01 * np.arange(240)[:, None]
        kw = dict(x0=xd)
    else:
        args = (np.array([15.0, 24.0, 24.0], np.float32),) + args[1:]
    with pytest.raises(AssertionError):
        DF.plan_window(*args, **kw)
    with pytest.raises(AssertionError):
        T.plan_window(*args, **kw)


@pytest.mark.parametrize("case", ["plain", "translated", "undersized"])
def test_rebuild_equal(system, case):
    jt, tt, x, box, jplan, tplan = system
    n = jt.n_atoms_real
    if case == "translated":
        x = x.copy()
        x[:n] += box * SHIFT            # whole-box translations
    if case == "undersized":
        jplan = dataclasses.replace(jplan, capacity=16)
        tplan = dataclasses.replace(tplan, capacity=16)
    ref = _jrebuild(jt, jplan, x, box)
    got = _trebuild(tt, tplan, x, box)
    for name, a, b in zip(("slot_atom", "inv_slot", "overflow"), ref, got):
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (int(got[2]) > 0) == (case == "undersized")
    assert (got[0] >= 0).sum() == (n if case != "undersized"
                                   else n - int(got[2]))


@pytest.mark.parametrize("translated", [False, True])
def test_inputs_equal(system, monkeypatch, translated):
    """Center rows exactly, the ghost array slot by slot within 1e-6 A."""
    jt, tt, x, box, jplan, tplan = system
    if translated:
        x = x.copy()
        x[:jt.n_atoms_real] += box * SHIFT
    cap, _, _, _ = _reference_call(monkeypatch, jt, jplan, x, box)
    j_center, j_ghost = cap.args[0], cap.args[1]
    sa = T.make_rebuild_fn(tplan, tt.atom_mask)(torch.tensor(x),
                                                torch.tensor(box))[0]
    direct = T.DirectForce(tt, tplan, exclusion_table(tt))
    center, ghost = direct.inputs(torch.tensor(x), torch.tensor(box), sa)
    np.testing.assert_array_equal(center[:, :7].numpy(), j_center[:, :7])
    valid = sa >= 0
    np.testing.assert_array_equal(valid.numpy(), j_center[:, 7] > 0.5)
    assert torch.equal(center[:, 7], torch.where(valid, sa + 1, 0).float())
    assert ghost.shape == j_ghost.shape == (8, 6 ** 3 * 128)
    np.testing.assert_allclose(ghost[:7].numpy(), j_ghost[:7], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ghost[7].numpy() > 0.5, j_ghost[7] > 0.5)
    # every slab starts where the reference's slab offsets put it
    offs = cap.args[3][0]
    p = np.arange(tplan.n_cells)
    i, j, k = p // 16, (p // 4) % 4, p % 4
    base = (((i + 1) * 6 + (j + 1)) * 6 + k) * 128
    np.testing.assert_array_equal(direct.starts.numpy(),
                                  base[:, None] + offs[None, :])


def _plain(system, x, stats=None, beta=BETA, masked=True):
    """The plain kernel on the wrapper's inputs, with the topology's
    exclusion table (masked) or an empty one."""
    _, tt, _, box, _, tplan = system
    sa, inv, _ = T.make_rebuild_fn(tplan, tt.atom_mask)(torch.tensor(x),
                                                       torch.tensor(box))
    direct = T.DirectForce(tt, tplan, exclusion_table(tt))
    center, ghost = direct.inputs(torch.tensor(x), torch.tensor(box), sa)
    out = T.direct_force_plain(center, ghost, direct.starts,
                               torch.tensor(1.0), beta, RC * RC,
                               stats=stats,
                               excl=direct.excl if masked
                               else Exclusions.empty(tt.atom_mask.shape[0]))
    return out, center, ghost, direct, sa, inv


def _reference_subtraction(jt, x, box, rc=RC):
    """The reference's own subtraction of the excluded and 1-4 pairs from
    its direct space: (e_lj, e_c, its force [N, 3]), in float32."""
    def e(xx):
        el = ec = 0.0
        for which in ("excl", "pair14"):
            a, b = DF.pairlist_kernel_formula_energy(
                xx, jnp.asarray(box), jt, getattr(jt, f"{which}_idx"),
                getattr(jt, f"{which}_mask"),
                jnp.asarray(1.0, jnp.float32), BETA, rc * rc)
            el, ec = el + a, ec + b
        return el + ec, (el, ec)

    (_, (el, ec)), g = jax.value_and_grad(e, has_aux=True)(
        jnp.asarray(x, jnp.float32))
    return float(el), float(ec), -torch.tensor(np.asarray(g, np.float32))


@pytest.mark.parametrize("translated", [False, True])
def test_plain_kernel_matches_pallas(system, monkeypatch, translated):
    jt, tt, x, box, jplan, tplan = system
    if translated:
        x = x.copy()
        x[:jt.n_atoms_real] += box * SHIFT
    cap, F_ref, elj_ref, ec_ref = _reference_call(monkeypatch, jt, jplan, x,
                                                  box)
    # with an empty table: every close pair, as the Pallas kernel
    stats = {}
    out, _, _, direct, sa, inv = _plain(system, x, stats, masked=False)
    out_ref = torch.tensor(cap.out)
    e_ref = T.cell_energies(out_ref, tplan.n_cells).sum(1)
    rel_f, rel_e = T.direct_force_parity(out[:, :3], T.cell_energies(
        out, tplan.n_cells).sum(1), out_ref[:, :3], stats)
    assert rel_f < 1e-5 and rel_e < 1e-5, (rel_f, rel_e)
    np.testing.assert_allclose(stats["e_cell"].numpy(), e_ref.numpy(),
                               rtol=0, atol=1e-5 * float(
                                   stats["e_abs"].max()))
    assert stats["pairs"] > 100000
    # with the table: the Pallas kernel less the reference's subtraction
    el_x, ec_x, f_x = _reference_subtraction(jt, x, box)
    masked = {}
    out_m, _, _, _, _, _ = _plain(system, x, masked)
    assert 0 < stats["pairs"] - masked["pairs"] <= 2 * len(
        exclusion_pairs(tt))
    real = sa >= 0
    f_want = out_ref[:, :3].clone()
    f_want[real] -= f_x[sa[real]]
    err = (out_m[:, :3] - f_want).abs().amax(dim=1)
    assert bool((err <= 1e-5 * stats["f_abs"]).all())
    e_m = T.cell_energies(out_m, tplan.n_cells).sum(0)
    assert abs(float(e_m[0]) - (elj_ref - el_x)) <= 1e-5 * stats["e_abs_lj"]
    assert abs(float(e_m[1]) - (ec_ref - ec_x)) <= 1e-5 * stats["e_abs_c"]
    # the wrapper: atom forces and total energies, with the table
    F, e_lj, e_c, ovf = direct(torch.tensor(x), torch.tensor(box),
                               torch.tensor(1.0), BETA, sa, inv)
    assert int(ovf) == 0
    assert abs(float(e_lj) - (elj_ref - el_x)) <= 1e-5 * stats["e_abs_lj"]
    assert abs(float(e_c) - (ec_ref - ec_x)) <= 1e-5 * stats["e_abs_c"]
    scale = stats["f_abs"][inv] * tt.atom_mask
    err = (F - (torch.tensor(F_ref) - f_x * tt.atom_mask[:, None])).abs()
    assert bool((err.amax(dim=1) <= 1e-5 * scale).all())


def test_plain_float32_floor(system):
    """The plain version in float32 against itself in float64 on the same
    rows: the float32 floor that the kernel-vs-plain gate of 1e-5 sits
    above."""
    stats = {}
    out, center, ghost, direct, _, _ = _plain(system, system[2], stats)
    out64 = T.direct_force_plain(center.double(), ghost.double(),
                                 direct.starts, torch.tensor(1.0).double(),
                                 BETA, RC * RC, excl=direct.excl)
    n_cells = direct.plan.n_cells
    rel_f, rel_e = T.direct_force_parity(
        out[:, :3].double(), T.cell_energies(out, n_cells).sum(1).double(),
        out64[:, :3], {k: (v.double() if torch.is_tensor(v) else v)
                       for k, v in stats.items()})
    del rel_e
    e64 = T.cell_energies(out64, n_cells).sum(1)
    de = (stats["e_cell"].double() - e64).abs() / stats["e_abs"].double()
    # measured: 4.9e-7 per slot, 1.3e-7 per cell (cell sums in float64;
    # 1.1e-6 and 7.7e-7 while the excluded pairs were evaluated)
    assert rel_f < 3e-6 and float(de.max()) < 2e-6, (rel_f, float(de.max()))


def test_parity_gate_catches_a_water_lj_error(system):
    """A 1e-3 error in water O's LJ well depth, which a limit of 1e-4 of
    max|F| lets through (0.0094 against max|F| of 162 kcal/mol/A, on the
    solute), fails the per-slot gate of 1e-5 by more than 10x. (The
    per-cell energy gate does not see it: the cells' Coulomb energies are
    far larger than the water O-O LJ energy.)"""
    jt, tt, x, box, _, tplan = system
    stats = {}
    out, center, ghost, direct, _, _ = _plain(system, x, stats)
    ws, wn = jt.water_start, jt.water_count * jt.water_site_count
    o_rows = torch.zeros(jt.n_atoms + 1, dtype=torch.bool)
    o_rows[ws:ws + wn:jt.water_site_count] = True
    sa = T.make_rebuild_fn(tplan, tt.atom_mask)(torch.tensor(x),
                                                torch.tensor(box))[0]
    water_o = o_rows[torch.where(sa < 0, jt.n_atoms, sa)]
    bad_c = center.clone()
    bad_c[water_o, 5] *= 1.0 + 1e-3
    bad_g = bad_c[direct.gsrc].T.contiguous()
    bad_g[:3] = ghost[:3]
    out_bad = T.direct_force_plain(bad_c, bad_g, direct.starts,
                                   torch.tensor(1.0), BETA, RC * RC,
                                   excl=direct.excl)
    f, f_bad = out[:, :3], out_bad[:, :3]
    assert float((f_bad - f).abs().max()) < 1e-4 * float(f.abs().max())
    rel_f, rel_e = T.direct_force_parity(
        f_bad, T.cell_energies(out_bad, tplan.n_cells).sum(1), f, stats)
    assert rel_f > 1e-4, (rel_f, rel_e)


def test_kernel_wrapper_checks(system):
    _, tt, _, _, _, tplan = system
    excl = exclusion_table(tt)
    with pytest.raises(ValueError):
        T.direct_force_cuda(tplan, torch.zeros((100, 8)),
                            torch.zeros((8, 100)), 1.0, BETA, excl=excl)
    big = dataclasses.replace(tplan, capacity=512)
    gx, gy, gz = big.ghost_dims
    with pytest.raises(ValueError):
        T.direct_force_cuda(big, torch.zeros((big.n_cells * 512, 8)),
                            torch.zeros((8, gx * gy * gz * 512)), 1.0, BETA,
                            excl=excl)
    # CPU tensors take the plain version and count no launch
    before = tracing.counters("direct_force")
    direct = T.DirectForce(tt, tplan, exclusion_table(tt))
    center = torch.zeros((tplan.n_cells * tplan.capacity, 8))
    ghost = center[direct.gsrc].T.contiguous()
    out = direct.kernel(center, ghost, torch.tensor(1.0), BETA)
    assert float(out.abs().max()) == 0.0
    assert tracing.counters("direct_force") == before


def test_crossing_atom_keeps_its_pairs(system, monkeypatch):
    """A water crosses the +x box face after the rebuild. With the images
    fixed at the rebuild (`image_shift`, as MdSim passes them) the kernel
    gives what a fresh rebuild gives; wrapped at the call (shift None) it
    loses the crossing sites' pairs, and the plain kernel without an
    exclusion table on those inputs reproduces the reference, which loses
    the excluded O-H and H-M pairs too (its rest energy still subtracts
    those). Cutoff 5.5 A on 6 A cells leaves a 0.5 A skin for the 0.2 A
    move."""
    jt, tt, x, box, _, _ = system
    rc = 5.5
    args = (box, rc, jt.n_atoms_real, jt.n_atoms)
    stride = jt.water_site_count
    o = np.arange(jt.water_start, jt.water_start + jt.water_count * stride,
                  stride)
    # the water whose H points furthest into the box: its O and M cross,
    # an H does not, so the wrapped kernel loses an H-M pair
    w = o[np.argmin(np.minimum(x[o + 1, 0], x[o + 2, 0]) - x[o, 0])]
    xa = x.copy()
    xa[w:w + stride, 0] += box[0] - 0.05 - x[w, 0]    # O 0.05 A inside
    xb = xa.copy()
    xb[w:w + stride, 0] += 0.2                        # O 0.15 A outside
    tplan = T.plan_window(*args, x0=xa)
    jplan = DF.plan_window(*args, x0=xa)
    assert tplan.cell_side[0] - rc == pytest.approx(0.5)
    direct = T.DirectForce(tt, tplan, exclusion_table(tt))
    rebuild = T.make_rebuild_fn(tplan, tt.atom_mask)
    tb = torch.tensor(box)
    one = torch.tensor(1.0)
    sa, inv, _ = rebuild(torch.tensor(xa), tb)
    shift = T.image_shift(torch.tensor(xa), tb)
    xbt = torch.tensor(xb)
    f_fix, *e_fix = direct(xbt, tb, one, BETA, sa, inv, shift)[:3]
    f_new, *e_new = direct(xbt, tb, one, BETA, *rebuild(xbt, tb)[:2])[:3]
    f_wrap, *e_wrap = direct(xbt, tb, one, BETA, sa, inv)[:3]
    fn = DF.make_pallas_direct_fn(jt, JCfg(lj_cutoff=rc, coulomb_cutoff=rc),
                                  jplan, interpret=True)
    sa_j, inv_j, _ = jax.jit(DF.make_rebuild_fn(jplan, jt.atom_mask))(
        jnp.asarray(xa), jnp.asarray(box))
    _, elj_r, ec_r, _ = fn(jnp.asarray(xb), jnp.asarray(box),
                           jnp.asarray(1.0, jnp.float32), BETA, sa_j, inv_j)
    e_r = float(elj_r) + float(ec_r)
    stats, stats_all = {}, {}
    center, ghost = direct.inputs(xbt, tb, rebuild(xbt, tb)[0])
    T.direct_force_plain(center, ghost, direct.starts, one, BETA, rc * rc,
                         stats=stats, excl=direct.excl)
    out_all = T.direct_force_plain(*direct.inputs(xbt, tb, sa),
                                   direct.starts, one, BETA, rc * rc,
                                   stats=stats_all, excl=Exclusions.empty(
                                       tt.atom_mask.shape[0]))
    wrap_all = float(T.cell_energies(out_all, tplan.n_cells).sum())
    scale = stats["e_abs_lj"] + stats["e_abs_c"]
    fix, new, wrap = (float(sum(e)) for e in (e_fix, e_new, e_wrap))
    assert abs(fix - new) <= 1e-6 * scale, (fix, new)
    assert abs(wrap_all - e_r) <= 1e-6 * (stats_all["e_abs_lj"]
                                          + stats_all["e_abs_c"]), (
        wrap_all, e_r)
    crossed = xb[w:w + stride, 0] >= box[0]
    assert crossed[0] and crossed[3] and not crossed[1:3].all()
    assert abs(wrap - new) > 1e2, (wrap, new)
    err = (f_fix - f_new).abs().amax(dim=1)
    a = stats["f_abs"][rebuild(xbt, tb)[1]] * tt.atom_mask
    assert bool((err <= 1e-5 * a + 1e-6).all())
    assert float((f_wrap - f_new).abs().max()) > 1e2
