"""The exclusion table (ops/exclusions.py) and what it is for: MdSim's
direct-space backends leave the excluded and 1-4 pairs out, so a bonded
pair that straddles a box face costs float32 nothing.

The face test: the solvated 8-residue polyalanine in a 24 A OPC box
(1,312 sites, 6 A cutoff, PME 24^3), moved whole so that the peptide's
centre sits on the x face of the box, which 40-odd of its excluded and 1-4
pairs then straddle. MdSim's whole force in float32 (direct space + the
rest energy) on K2's plain twin, the cluster twin and the window backend
is held to the benchmark's plain float64 reference
(benchmark/reference/physics.py: exact erfc, its own pair search) at the
solute atoms within 2 A of the face, as the benchmark's check reads a gap:
|dF| / (|F_ref| + median |F_ref|), and elsewhere. The limit, 2e-4, sits
13x above the largest reading of the three backends (5.4e-6 at the face,
1.5e-5 elsewhere: PME's float32 mesh, the A&S erfc) and 10x below the
least of the add-and-subtract design on the same state (6.3e-3 to 1.8e-2
at the face, 2.1e-3 to 2.6e-3 elsewhere): there, the backend's wrapped
coordinates and the rest energy's minimum image round a bonded pair's
1e4-1e5 kcal/mol/A apart, and a solute atom's excluded pairs leave a
float32 residue wherever it sits.
"""
import numpy as np
import pytest
import torch

from benchmark.reference.physics import System
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.engine import MdSim
from molchanica_tpu_torch.ops import clusters as TCl
from molchanica_tpu_torch.ops.exclusions import (Exclusions,
                                                 exclusion_pairs,
                                                 exclusion_table)
from molchanica_tpu_torch.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           make_topology)

torch.set_num_threads(1)

RC = 6.0
FACE_LIMIT = 2e-4
BACKENDS = {"pallas": dict(use_pallas=True),
            "clusters": dict(),
            "window": dict(direct_backend="window")}


@pytest.fixture(scope="module")
def face():
    """(topology, float32 positions with the peptide's centre on the x
    face, box, the solute atoms within 2 A of that face)."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    top = asys.topology
    box = np.asarray(asys.box_extent, np.float64)
    x = np.asarray(asys.positions, np.float64)
    n = top.n_atoms_real
    solute = np.asarray(top.dof_mask)[:n] > 0
    solute[top.water_start:] = False
    shift = box / 2 - x[:n][solute].mean(0)
    shift[0] -= box[0] / 2
    x[:n] += shift
    x[:n] -= box * np.floor(x[:n] / box)
    d_face = np.minimum(x[:, 0], box[0] - x[:, 0])
    near = np.zeros(top.n_atoms, bool)
    near[:n] = solute & (d_face[:n] < 2.0)
    return top, x.astype(np.float32), box.astype(np.float32), near


def _straddling(top, x, box):
    p = exclusion_pairs(top)
    return int((np.abs(x[p[:, 0], 0] - x[p[:, 1], 0]) > box[0] / 2).sum())


def _md(top, x, box, **kw):
    return MdSim(top, MdConfig(
        integrator=Integrator.langevin_middle(gamma=1.0),
        hydrogen_constraint=HydrogenConstraint.shake(), lj_cutoff=RC,
        coulomb_cutoff=RC, pme_grid=(24, 24, 24), dtype="float32",
        max_init_relaxation_iters=None, **kw), x, box_extent=box,
        method="cells_pme", relax=False, device="cpu")


def _reference_force(top, x, box):
    arrays = {f: np.asarray(getattr(top, f).cpu()) for f in TENSOR_FIELDS}
    statics = {f: getattr(top, f) for f in STATIC_FIELDS}
    md = dict(lj_cutoff=RC, coulomb_cutoff=RC, ewald_rtol=1e-5,
              pme_grid=[24, 24, 24], temp_target=310.0,
              integrator=["langevin_middle", {"gamma": 1.0}],
              hydrogen_constraint=["shake", {}])
    ref = System(arrays, statics, box, md, "cpu")
    return ref.forces(torch.tensor(x, dtype=torch.float64))[0]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_bonded_pairs_across_a_face_cost_float32_nothing(face, backend):
    top, x, box, near = face
    assert _straddling(top, x, box) >= 20 and near.sum() >= 20
    md = _md(top, x, box, **BACKENDS[backend])
    assert md._nbr_backend == backend
    s = md.state
    f = md.force_fn(s.positions, s.box, s.couple)[0].double()
    f_ref = _reference_force(top, s.positions.numpy(), box)
    dof = md.top.dof_mask.numpy() > 0
    mag = torch.linalg.norm(f_ref, dim=1)
    gap = torch.linalg.norm(f - f_ref, dim=1) / (mag + mag[dof].median())
    gap_near = float(gap[torch.as_tensor(near)].max())
    gap_far = float(gap[torch.as_tensor(dof & ~near)].max())
    print(f"{backend}: face {gap_near:.3e}, elsewhere {gap_far:.3e}")
    assert gap_near < FACE_LIMIT and gap_far < FACE_LIMIT, (gap_near,
                                                            gap_far)


def _check_table(top):
    table = exclusion_table(top)
    p = torch.as_tensor(exclusion_pairs(top))
    n = top.atom_mask.shape[0]
    reach = 32 * table.words
    assert reach - 32 < int((p[:, 1] - p[:, 0]).max()) <= reach
    i = torch.arange(n)[:, None]
    j = i + torch.arange(-reach - 2, reach + 3)[None, :]
    got = table.excluded(i.expand_as(j), j)
    want = torch.zeros_like(got)
    for a, b in ((p[:, 0], p[:, 1]), (p[:, 1], p[:, 0])):
        want[a, b - a + reach + 2] = True
    assert torch.equal(got, want)
    assert torch.equal(table.excluded(p[:, 1], p[:, 0]),
                       torch.ones(len(p), dtype=torch.bool))
    return table, p


@pytest.mark.parametrize("config", ["config3_k2", "config5_duplex"])
def test_table_marks_exactly_the_excluded_and_14_pairs(config):
    """Every offset within the reach and two past it, at every site: set
    exactly on the unmasked pairs of excl_idx and pair14_idx, in either
    order (config 3: 40,655 + 1,746 pairs, reach 32; the duplex: 16,773 +
    496, reach 64)."""
    import os

    from benchmark import cells

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = cells.load_config(config, root)
    arrays, statics, _, _ = cells.load_system(cfg, root)
    top = cells.topology(arrays, statics, "cpu")
    table, p = _check_table(top)
    assert (len(p), table.words) == {"config3_k2": (42401, 1),
                                     "config5_duplex": (17269, 2)}[config]


def test_table_of_a_topology_without_pairs_and_of_far_pairs():
    """No pairs: one word, nothing excluded. A pair 70 sites apart: the
    reach grows to 96 and the table to three words a site."""
    n = 100
    rng = np.random.default_rng(0)
    args = (np.ones(n) * 12, rng.normal(size=n) * 0.1,
            np.full(n, 3.0), np.full(n, 0.1))
    table = exclusion_table(make_topology(*args))
    assert table.words == 1 and not bool(table.bits.any())
    empty = Exclusions.empty(n)
    assert torch.equal(empty.bits, table.bits)
    assert empty.pairs.shape == table.pairs.shape == (0, 2)
    top = make_topology(*args, exclusions=[(3, 73), (10, 11)],
                        pairs14=[(20, 23)])
    table, p = _check_table(top)
    assert table.words == 3 and len(p) == 3


def test_cluster_flags_mark_exactly_the_entries_with_excluded_pairs(face):
    """The cluster rebuild's flags: entry (c, k) is flagged iff some atom
    of cluster c and some atom of cluster nbr[c, k] are a pair of the
    table, on the face state (both directions of every pair, the self
    entries included); the flagged entries hold every excluded pair; the
    rebuild under torch.func.vmap (the farm's) gives each replica's single
    call."""
    top, x, box, _ = face
    xt, bt = torch.tensor(x), torch.tensor(box)
    table = exclusion_table(top)
    plan = TCl.plan_clusters(box, RC, top.n_atoms_real, top.n_atoms)
    rebuild = TCl.make_cluster_rebuild_fn(plan, top, table)
    order, nbr, flags, ovf = rebuild(xt, bt)
    assert int(ovf) == 0 and flags.dtype == torch.uint8
    atoms = order.reshape(-1, TCl.CL)
    c, k = torch.nonzero(nbr >= 0, as_tuple=True)
    a_i = atoms[c][:, :, None].expand(-1, -1, TCl.CL)       # [E, 8, 8]
    a_j = atoms[nbr[c, k]][:, None, :].expand(-1, TCl.CL, -1)
    want = table.excluded(a_i, a_j)
    assert torch.equal(flags[c, k] == 1, want.any(dim=(1, 2)))
    assert int(want[flags[c, k] == 1].sum()) == 2 * len(table.pairs)
    assert not flags[nbr < 0].any()
    xs = torch.stack([xt, xt + 0.05 * torch.randn(xt.shape,
                                                  generator=torch.Generator(
                                                  ).manual_seed(2))])
    batched = torch.func.vmap(rebuild, in_dims=(0, None))(xs, bt)
    for r in range(2):
        for b_, s_ in zip(batched, rebuild(xs[r], bt)):
            assert torch.equal(b_[r], s_)
