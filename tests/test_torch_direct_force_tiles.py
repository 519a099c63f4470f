"""The schedule of the cell-grid kernel K2 (csrc/direct_force.cu), held to
the plain torch kernel on the CPU.

`direct_force_work` models what the kernel visits: per cell, its real
sites cut into parts of at most PART_I; per part, the real sites of the 27
neighbour cells kept if they lie within rc of the bounding box of the
part's own center rows; 32-site j chunks over the warps; per chunk the
pairs with r^2 < rc^2 and r^2 > 1e-9, queued and run in 32-lane batches,
where an excluded pair takes its lane and adds nothing.
The prefilter may drop no pair: on every grid below the model's pairs must
be exactly the pairs `direct_force_plain` evaluates (the same float32 r^2
expression on the same inputs, the same exclusion table: no tolerance). The
grids: the solvated 8-residue polyalanine (capacity 128, 4 x 4 x 4 cells),
random sites dense enough for capacity 256, an nc = 3 grid (the 27
neighbours are the whole box through the halo), atoms moved across the box
faces after the rebuild (their images fixed at the rebuild, so their center
rows lie outside [0, box)), pairs just inside the cutoff across the faces,
and a cell layout whose real sites are not a prefix of the cell's slots
(the kernel ranks real sites by their valid flag and assumes no prefix).
"""
import types

import numpy as np
import pytest
import torch

from molchanica_tpu_torch.ops import direct_force as T
from molchanica_tpu_torch.ops.exclusions import exclusion_table
from molchanica_tpu_torch.ops.pme import ewald_beta_for
from molchanica_tpu_torch.systems.bench_systems import build_solvated_protein

torch.set_num_threads(1)


def _top(rng, n, n_coupled=3):
    """Random sites with no excluded or 1-4 pairs."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    no_pairs = torch.zeros((0, 2), dtype=torch.int64)
    return types.SimpleNamespace(
        charges=f32(rng.normal(0, 0.4, n)),
        lj_sigma=f32(rng.uniform(2.8, 3.4, n)),
        lj_eps=f32(rng.uniform(0.05, 0.2, n)),
        couple_mask=f32(np.arange(n) < n_coupled),
        atom_mask=f32(np.ones(n)), excl_idx=no_pairs,
        excl_mask=f32(np.zeros(0)), pair14_idx=no_pairs,
        pair14_mask=f32(np.zeros(0)))


def _grid(top, x0, box, rc, x1=None, permute=None):
    """(plan, direct, center, ghost): binned at x0, evaluated at x1 (x0 by
    default) with the images fixed at the rebuild; `permute`, a generator,
    shuffles each cell's slots."""
    plan = T.plan_window(box, rc, int(top.atom_mask.sum()), x0.shape[0],
                         x0=x0)
    xt, bt = torch.tensor(x0), torch.tensor(box)
    sa, _, ovf = T.make_rebuild_fn(plan, top.atom_mask)(xt, bt)
    assert int(ovf) == 0
    if permute is not None:
        perm = torch.stack([torch.tensor(permute.permutation(plan.capacity))
                            for _ in range(plan.n_cells)])
        base = torch.arange(plan.n_cells)[:, None] * plan.capacity
        sa = sa[(base + perm).reshape(-1)]
    direct = T.DirectForce(top, plan, exclusion_table(top))
    x = xt if x1 is None else torch.tensor(x1)
    center, ghost = direct.inputs(x, bt, sa, T.image_shift(xt, bt))
    return plan, direct, center, ghost


def _check(plan, direct, center, ghost):
    """The model's pairs against the plain version's; returns the model's
    counts."""
    stats = {"keys": None}
    T.direct_force_plain(center, ghost, direct.starts, torch.tensor(0.5),
                         ewald_beta_for(plan.cutoff, 1e-5), direct.rc2,
                         stats=stats, excl=direct.excl)
    work = T.direct_force_work(center, ghost, direct.starts, direct.rc2,
                               keys=True, excl=direct.excl)
    assert stats["pairs"] > 0
    assert work["pairs"] == stats["pairs"]
    assert torch.equal(work["keys"], stats["keys"])
    n_real = int((center[:, 7] > 0.5).sum())
    # every real site in exactly one part; chunks tile the staged sites
    assert work["sites"] == n_real
    assert work["active_blocks"] <= work["blocks"] == \
        plan.n_cells * plan.capacity // T.PART_I
    assert work["staged"] <= work["real"] <= work["scanned"]
    assert work["staged"] <= 32 * work["chunks"] < work["staged"] \
        + 32 * work["active_blocks"]
    assert work["pairs"] <= work["queued"]
    assert -(-work["queued"] // 32) <= work["batches"]
    assert 0.0 < work["lane_use"] <= 1.0
    return work


def _random(seed, box, density):
    rng = np.random.default_rng(seed)
    box = np.asarray(box, np.float32)
    n = int(density * np.prod(box))
    x = (rng.uniform(0, 1, (n, 3)) * box).astype(np.float32)
    return rng, _top(rng, n), x, box


def test_solvated_capacity_128():
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    top = asys.topology
    x = np.asarray(asys.positions, np.float32)
    box = np.asarray(asys.box_extent, np.float32)
    plan, direct, center, ghost = _grid(top, x, box, 6.0)
    assert plan.capacity == 128 and plan.nc == (4, 4, 4)
    work = _check(plan, direct, center, ghost)
    # the excluded pairs are queued and left out at the math
    assert work["queued"] > work["pairs"]
    # the prefilter drops real neighbours; the schedule uses every block
    assert work["staged"] < work["real"]
    assert work["active_blocks"] >= plan.n_cells


def test_random_capacity_256():
    _, top, x, box = _random(4, (26.0, 27.0, 28.0), 0.35)
    plan, direct, center, ghost = _grid(top, x, box, 6.5)
    assert plan.capacity == 256 and plan.nc == (4, 4, 4)
    work = _check(plan, direct, center, ghost)
    assert work["staged"] < work["real"]


def test_nc3_whole_box_through_the_halo():
    _, top, x, box = _random(5, (19.0, 19.5, 20.0), 0.1)
    plan, direct, center, ghost = _grid(top, x, box, 6.0)
    assert plan.nc == (3, 3, 3)
    _check(plan, direct, center, ghost)


def test_atoms_moved_across_the_faces():
    """Sites binned 0.05 A inside a face, then moved 0.2 A through it (and
    every site by 0.25 A rms): their center rows lie outside [0, box), in
    the near cell, and the bounding box taken from the rows covers them."""
    rng, top, x, box = _random(6, (24.0, 25.0, 26.0), 0.1)
    n_face = 12
    axis = np.arange(n_face) % 3
    lo = np.arange(n_face) % 2 == 0
    x[np.arange(n_face), axis] = np.where(lo, 0.05, box[axis] - 0.05)
    x1 = x + rng.normal(0, 0.25, x.shape).astype(np.float32)
    x1[np.arange(n_face), axis] = x[np.arange(n_face), axis] \
        + np.where(lo, -0.2, 0.2)
    plan, direct, center, ghost = _grid(top, x, box, 5.5, x1=x1)
    assert plan.cell_side[0] - 5.5 > 0.2
    rows = center[center[:, 7] > 0.5, :3]
    outside = ((rows < 0) | (rows >= torch.tensor(box))).any(1)
    assert int(outside.sum()) >= n_face
    _check(plan, direct, center, ghost)


def test_pairs_just_inside_the_cutoff_across_faces():
    """Site pairs whose float32 r^2 lies just below rc^2, each pair split
    by a box face, one site near each face: the ghost image is the one in
    range, at the far edge of the part's neighbourhood."""
    rng, top, x, box = _random(7, (21.0, 22.0, 23.0), 0.05)
    rc = 6.0
    for k, a in enumerate((0, 1, 2)):
        i, j = 2 * k, 2 * k + 1
        x[i] = x[j] = box / 2
        x[i, a] = 0.3
        x[j, a] = box[a] + 0.3 - rc * (1 - 1e-6)
    plan, direct, center, ghost = _grid(top, x, box, rc)
    work = _check(plan, direct, center, ghost)
    stats = {"keys": None}
    T.direct_force_plain(center, ghost, direct.starts, torch.tensor(1.0),
                         0.3, direct.rc2, stats=stats, excl=direct.excl)
    assert work["pairs"] == stats["pairs"]


def test_real_sites_not_a_prefix_of_the_cell():
    rng, top, x, box = _random(8, (24.0, 25.0, 26.0), 0.1)
    plan, direct, center, ghost = _grid(top, x, box, 6.0, permute=rng)
    real = (center[:, 7] > 0.5).reshape(plan.n_cells, -1)
    first_empty = torch.argmin(real.int(), dim=1)
    assert bool((real.sum(1) > first_empty).any())      # not a prefix
    _check(plan, direct, center, ghost)


def test_parts_cut_each_cell_evenly():
    """A cell of n real sites takes ceil(n / PART_I) blocks of at most
    PART_I sites each, none empty; the others of its C / PART_I exit."""
    rng, top, x, box = _random(9, (26.0, 27.0, 28.0), 0.2)
    plan, direct, center, ghost = _grid(top, x, box, 6.5)
    work = T.direct_force_work(center, ghost, direct.starts, direct.rc2,
                               excl=direct.excl)
    n_c = (center[:, 7] > 0.5).reshape(plan.n_cells, -1).sum(1)
    assert work["active_blocks"] == int(((n_c + T.PART_I - 1)
                                         // T.PART_I).sum())
    assert 1 <= work["min_part_sites"] <= work["max_part_sites"] <= T.PART_I
    assert work["sites"] == int(n_c.sum())


def test_plain_takes_beta_as_a_device_scalar():
    """MdSim hands K2 its Ewald beta as a float32 scalar on its device,
    made once per plan, so that a launch copies nothing from the host. On
    the CPU the plain version takes that scalar and agrees with a Python
    float beta to float32 roundoff (1e-6 of the pair-term magnitudes per
    slot and per cell)."""
    rng, top, x, box = _random(11, (24.0, 25.0, 26.0), 0.1)
    plan, direct, center, ghost = _grid(top, x, box, 7.0)
    beta = ewald_beta_for(plan.cutoff, 1e-5)
    couple = torch.tensor(0.5)
    stats = {}
    ref = T.direct_force_plain(center, ghost, direct.starts, couple, beta,
                               direct.rc2, stats=stats, excl=direct.excl)
    out = T.direct_force_plain(center, ghost, direct.starts, couple,
                               torch.tensor(beta, dtype=torch.float32),
                               direct.rc2, excl=direct.excl)
    e = T.cell_energies(out, plan.n_cells).sum(1)
    rel_f, rel_e = T.direct_force_parity(out[:, :3], e, ref[:, :3], stats)
    assert rel_f < 1e-6 and rel_e < 1e-6


def test_wrapper_checks_counts():
    rng, top, x, box = _random(10, (20.0, 20.0, 20.0), 0.05)
    plan, direct, center, ghost = _grid(top, x, box, 6.0)
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError):
            T.direct_force_cuda(plan, center, ghost, torch.tensor(1.0), 0.3,
                                counts=bad, excl=direct.excl)
