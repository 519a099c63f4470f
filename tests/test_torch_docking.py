"""Port parity: molchanica_tpu_torch.docking (site finding, the receptor
setup, pose enumeration, the batched pose scorer and MD shooting) against
molchanica_tpu.docking, on the committed pocket fixture typed by each
package's own readers and GAFF2 chain, and on the JAX tests' synthetic
shell pocket.

Tolerances:
- find_sites, the DockingSetup fields and init_poses: exact (numpy on the
  host, the setup's tensors against the reference's arrays).
- score_poses: the clash masks identical, +inf totals on the same poses,
  and per term and pose an error within SCORE_TOL of the sum of that
  pose's pair-term magnitudes (pose_term_magnitudes: the Gaussian wells'
  terms weighted by 1 + their exponent, which float32 rounds to within
  x eps), plus the smallest normal float32 per pair: both sides sum
  float32 pair terms clipped at +-1e5 in different orders, round the
  wells' exponents apart, and the JAX package flushes subnormal terms to
  zero.
- dock_md in float64 at Langevin gamma 0, both MdSims started from the
  same numpy velocities (a test-side subclass of each package's MdSim):
  the interaction trace within rel 1e-8 of its largest magnitude and
  ligand_final within 1e-6 A.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.docking import poses as JPoses
from molchanica_tpu.docking import scorer as JScorer
from molchanica_tpu.docking import shoot as JShoot
from molchanica_tpu.docking.setup import DockingSetup as JSetup
from molchanica_tpu.docking.site import DockingSite as JSite
from molchanica_tpu.docking.site import find_sites as j_find_sites
from molchanica_tpu.io.sdf import read_sdf as j_read_sdf
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.molecules.pocket import MoleculePocket as JPocket
from molchanica_tpu.molecules.spec import MolSpec as JSpec
from molchanica_tpu_torch import density as TD
from molchanica_tpu_torch.constants import ACCEL_FACTOR, KB
from molchanica_tpu_torch.docking import poses as TPoses
from molchanica_tpu_torch.docking import shoot as TShoot
from molchanica_tpu_torch.docking.scorer import (find_optimal_pose,
                                                 pose_term_magnitudes,
                                                 score_poses)
from molchanica_tpu_torch.docking.setup import TENSOR_FIELDS, DockingSetup
from molchanica_tpu_torch.docking.site import DockingSite, find_sites
from molchanica_tpu_torch.io import read_sdf
from molchanica_tpu_torch.md.config import Integrator
from molchanica_tpu_torch.molecules.pocket import MoleculePocket
from molchanica_tpu_torch.molecules.spec import MolSpec
from molchanica_tpu_torch.sfc_mesh import molecular_surface
from molchanica_tpu_torch.topology import TENSOR_FIELDS as TOP_FIELDS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FDIR = os.path.join(ROOT, "molchanica_tpu", "systems", "data")
FPDB = os.path.join(FDIR, "pocket_fixture.pdb")
FSDF = os.path.join(FDIR, "pocket_ligand.sdf")

SCORE_TOL = 1e-5
TERMS = ("lj", "coulomb", "h_bonds", "hydrophobic")
N_SCORED = 512
F32_TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module")
def fixture():
    """Both packages' typed receptor and ligand, the fixture test's site
    (ligand centroid, radius min(r, 9)) and each package's setup."""
    lig_j, lig_t = j_read_sdf(FSDF), read_sdf(FSDF)
    pj = JPocket.from_file(FPDB, pdb_id="fixture", ligand=lig_j)
    pt = MoleculePocket.from_file(FPDB, pdb_id="fixture", ligand=lig_t)
    c, r = pt.docking_site()
    radius = min(float(r), 9.0)
    out = dict(
        rec=(pj.mol.to_spec(strict=False), pt.mol.to_spec(strict=False)),
        lig=(lig_j.to_spec(strict=False), lig_t.to_spec(strict=False)),
        elements=(pt.mol.elements, lig_t.elements),
        site=(JSite(site_center=c, site_radius=radius),
              DockingSite(site_center=c, site_radius=radius)),
        mols=(pj.mol, pt.mol))
    out["setup"] = (JSetup.new(out["rec"][0], out["site"][0]),
                    DockingSetup.new(out["rec"][1], out["site"][1],
                                     device="cpu"))
    out["poses"] = TPoses.init_poses(out["lig"][1].positions, c,
                                     site_radius=radius, n_grid=8,
                                     n_orientations=60)
    return out


def _same_setup(j, t):
    for f in TENSOR_FIELDS:
        a = getattr(t, f)
        assert a.device.type == "cpu" and a.dtype == torch.float32, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert t.n_rec_real == j.n_rec_real
    assert _site(t.site) == _site(j.site)


def _site(s):
    return tuple(s.site_center), s.site_radius


def _same_scores(e_j, e_t, mag, n_pairs):
    """score_poses of both packages on the same poses of n_pairs ligand-
    receptor pairs each, at the stated tolerance (module docstring)."""
    floor = F32_TINY * n_pairs
    np.testing.assert_array_equal(e_t.clash, np.asarray(e_j.clash))
    inf_t, inf_j = np.isinf(e_t.total), np.isinf(np.asarray(e_j.total))
    np.testing.assert_array_equal(inf_t, inf_j)
    np.testing.assert_array_equal(inf_t, e_t.clash)
    for k in TERMS + ("total",):
        a = np.asarray(getattr(e_j, k), np.float64)
        b = getattr(e_t, k).astype(np.float64)
        assert getattr(e_t, k).dtype == np.float32
        keep = np.isfinite(a) if k == "total" else slice(None)
        err = np.abs(a[keep] - b[keep])
        # XLA on the CPU flushes float32 subnormals to zero, torch does not
        assert np.all(err <= SCORE_TOL * mag[k][keep] + floor), \
            (k, float((err / np.maximum(mag[k][keep], floor)).max()))


def test_find_sites_equals_reference(fixture):
    """Grid-scan pockets of the fixture receptor: the reference's sites."""
    x = fixture["rec"][1].positions
    got = find_sites(x)
    assert [_site(s) for s in got] == [_site(s) for s in j_find_sites(x)]
    assert len(got) >= 1 and all(s.site_radius == 8.0 for s in got)
    assert [_site(s) for s in find_sites(x, max_sites=2)] == \
        [_site(s) for s in j_find_sites(x, max_sites=2)]


@pytest.mark.parametrize("classify", ["masses", "elements"])
def test_setup_equals_reference(fixture, classify):
    """DockingSetup.new in both branches of its donor / acceptor /
    hydrophobic rules: every padded field equal to the reference's array
    (R = 256 for the 191 culled atoms; padding rows at 1e4 A, sigma 1,
    mask 0)."""
    rec_j, rec_t = fixture["rec"]
    site_j, site_t = fixture["site"]
    el = fixture["elements"][0] if classify == "elements" else None
    j = JSetup.new(rec_j, site_j, elements=el)
    t = DockingSetup.new(rec_t, site_t, elements=el, device="cpu")
    _same_setup(j, t)
    assert t.n_rec_real == 191 and t.rec_pos.shape == (256, 3)
    assert float(t.rec_pos[-1, 0]) == 1e4 and float(t.rec_sigma[-1]) == 1.0
    assert float(t.rec_acceptor.sum()) > 0
    assert float(t.rec_hydrophobic.sum()) > 0
    moved = t.to("cpu")
    assert moved.n_rec_real == t.n_rec_real and moved.device.type == "cpu"


def test_init_poses_bit_identical(fixture):
    """init_poses at the reference budget (n_grid 8, 60 orientations:
    27,360 poses), with torsions, and with max_poses; the helpers."""
    lig = fixture["lig"][1]
    site = fixture["site"][1]
    kw = dict(site_radius=site.site_radius, n_grid=8, n_orientations=60)
    ref = JPoses.init_poses(lig.positions, site.site_center, **kw)
    got = fixture["poses"]
    assert got.shape == (27360, 33, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    tors = [((0, 1), [5, 6, 7]), ((1, 2), [8, 9])]
    kw = dict(site_radius=6.0, n_grid=3, n_orientations=7, torsions=tors,
              max_poses=500, seed=3)
    np.testing.assert_array_equal(
        TPoses.init_poses(lig.positions, (1.0, 2.0, 3.0), **kw),
        JPoses.init_poses(lig.positions, (1.0, 2.0, 3.0), **kw))
    for n in (1, 10, 60):
        q = TPoses.fibonacci_orientations(n)
        np.testing.assert_array_equal(q, JPoses.fibonacci_orientations(n))
        np.testing.assert_array_equal(TPoses.quat_to_mat(q),
                                      JPoses.quat_to_mat(q))
    np.testing.assert_array_equal(
        TPoses.apply_torsion(lig.positions, (0, 1), [5, 6], 1.1),
        JPoses.apply_torsion(lig.positions, (0, 1), [5, 6], 1.1))


@pytest.mark.parametrize("classify", ["masses", "elements", "donors"])
def test_score_poses_on_the_fixture(fixture, classify):
    """score_poses on 512 of the fixture's 27,360 poses (every 53rd), in
    batches of 128 with a repeated last pose to fill the final batch; then
    the fixture test's contract on the port. Gasteiger gives no hydrogen
    of the fixture a charge above 0.25, so no donor: the "donors" case
    sets the ligand's hydrogens to +0.3 (its carbons take the balance)
    to put the H-bond term to work."""
    lig_j, lig_t = fixture["lig"]
    setup_j, setup_t = fixture["setup"]
    poses = fixture["poses"][::53][:N_SCORED + 3]
    el = fixture["elements"][1] if classify != "masses" else None
    if classify == "donors":
        q = np.asarray(lig_t.charges).copy()
        h = np.array([e == "H" for e in el])
        c = np.array([e == "C" for e in el])
        q[h] = 0.3
        q[c] -= (q.sum() - np.sum(lig_t.charges)) / c.sum()
        lig_j = dataclasses.replace(lig_j, charges=q)
        lig_t = dataclasses.replace(lig_t, charges=q)
    if el is not None:
        rec_el = fixture["elements"][0]
        setup_j = JSetup.new(fixture["rec"][0], fixture["site"][0],
                             elements=rec_el)
        setup_t = DockingSetup.new(fixture["rec"][1], fixture["site"][1],
                                   elements=rec_el, device="cpu")
    e_j = JScorer.score_poses(setup_j, lig_j, poses, el, batch_size=128)
    e_t = score_poses(setup_t, lig_t, poses, el, batch_size=128,
                      device="cpu")
    mag = pose_term_magnitudes(setup_t, lig_t, poses, el, batch_size=128,
                               device="cpu")
    _same_scores(e_j, e_t, mag, poses.shape[1] * setup_t.rec_pos.shape[0])
    assert len(e_t.total) == len(poses)
    # the best ten: near-tied poses may swap places, so totals, not indices
    best_t, best_j = np.sort(e_t.total)[:10], np.sort(e_j.total)[:10]
    assert np.all(np.abs(best_t.astype(np.float64) - best_j)
                  <= SCORE_TOL * mag["total"].max())
    assert np.isfinite(e_t.total[~e_t.clash]).all()
    assert (~e_t.clash).sum() > 10
    assert e_t.total.min() < 0.0
    assert np.abs(e_t.hydrophobic).max() > 0.0
    assert (np.abs(e_t.h_bonds).max() > 0.0) == (classify == "donors")


def test_fixture_contract_on_the_port(fixture):
    """tests/test_pocket_fixture.py's scorer contract, its poses (n_grid 4,
    8 orientations, 256 drawn), on the port: clashed poses +inf, every
    surviving total finite, more than 10 survive, the best below 0."""
    lig = fixture["lig"][1]
    site = fixture["site"][1]
    poses = TPoses.init_poses(lig.positions, site.site_center,
                              site_radius=float(site.site_radius), n_grid=4,
                              n_orientations=8, max_poses=256, seed=1)
    e = score_poses(fixture["setup"][1], lig, poses, batch_size=256,
                    device="cpu")
    assert np.isinf(e.total[e.clash]).all()
    assert np.isfinite(e.total[~e.clash]).all()
    assert (~e.clash).sum() > 10
    assert e.total.min() < 0.0


def _shell_receptor(spec, radius=6.0, n=60):
    """tests/test_docking.py's spherical shell of carbon-like atoms."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    pos = radius * np.stack([np.sin(phi) * np.cos(theta),
                             np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    return spec(masses=np.full(n, 12.01), charges=np.zeros(n),
                lj_sigma=np.full(n, 3.4), lj_eps=np.full(n, 0.1),
                positions=pos)


def _line_ligand(spec, n=3):
    pos = np.zeros((n, 3))
    pos[:, 0] = np.arange(n) * 1.5
    return spec(masses=np.full(n, 12.01), charges=np.zeros(n),
                lj_sigma=np.full(n, 3.4), lj_eps=np.full(n, 0.1),
                positions=pos)


def test_score_poses_shell_cases():
    """tests/test_docking.py's three shell poses (centered in the pocket,
    on the shell, far away) in a batch of 4: the reference's scores, the
    clash culled, the pocket beating vacuum, the far pose ~0."""
    lig_j, lig_t = _line_ligand(JSpec), _line_ligand(MolSpec)
    s_j = JSetup.new(_shell_receptor(JSpec), JSite((0.0, 0.0, 0.0), 8.0))
    s_t = DockingSetup.new(_shell_receptor(MolSpec),
                           DockingSite((0.0, 0.0, 0.0), 8.0), device="cpu")
    _same_setup(s_j, s_t)
    centered = lig_t.positions - lig_t.positions.mean(0)
    poses = np.stack([centered, centered + np.array([6.0, 0.0, 0.0]),
                      centered + np.array([40.0, 0.0, 0.0])]).astype(
                          np.float32)
    e_j = JScorer.score_poses(s_j, lig_j, poses, batch_size=4)
    e_t = score_poses(s_t, lig_t, poses, batch_size=4, device="cpu")
    _same_scores(e_j, e_t, pose_term_magnitudes(s_t, lig_t, poses,
                                                batch_size=4, device="cpu"),
                 3 * 256)
    assert np.isinf(e_t.total[1])
    assert e_t.total[0] < e_t.total[2]
    assert abs(e_t.total[2]) < 1e-3


def test_find_optimal_pose():
    """find_optimal_pose on the shell pocket: the pose inside it first,
    the reference's order and totals, the clashed pose last."""
    lig_j, lig_t = _line_ligand(JSpec), _line_ligand(MolSpec)
    s_j = JSetup.new(_shell_receptor(JSpec), JSite((0.0, 0.0, 0.0), 8.0))
    s_t = DockingSetup.new(_shell_receptor(MolSpec),
                           DockingSite((0.0, 0.0, 0.0), 8.0), device="cpu")
    c = lig_t.positions - lig_t.positions.mean(0)
    poses = np.stack([c + np.array([0.0, 0.0, z]) for z in
                      (40.0, 0.0, 6.0, 1.0, -2.0)]).astype(np.float32)
    idx_j, e_j = JScorer.find_optimal_pose(s_j, lig_j, poses, top_k=4)
    idx_t, e_t = find_optimal_pose(s_t, lig_t, poses, top_k=4, device="cpu")
    np.testing.assert_array_equal(idx_t, idx_j)
    assert 2 not in idx_t and np.isfinite(e_t.total[idx_t]).all()
    _same_scores(e_j, e_t, pose_term_magnitudes(s_t, lig_t, poses,
                                                device="cpu"), 3 * 256)


def _v0(masses, dof_mask, temp):
    """Maxwell-Boltzmann velocities at `temp` drawn with numpy from a fixed
    seed: both packages' MdSims start from these."""
    rng = np.random.default_rng(7)
    m = np.maximum(np.asarray(masses, np.float64), 1e-6)
    sd = np.sqrt(KB * temp * ACCEL_FACTOR / m)
    return rng.normal(size=(m.size, 3)) * sd[:, None] \
        * np.asarray(dof_mask, np.float64)[:, None]


class _RefMd(JShoot.MdSim):
    """The reference's MdSim on its float32 topology cast to float64 (as
    the port's MdSim casts its own), from _v0's velocities."""
    def __init__(self, top, cfg, x0, **kw):
        top = top.replace(**{
            f: jnp.asarray(np.asarray(getattr(top, f)), jnp.float64)
            for f in TOP_FIELDS
            if np.issubdtype(np.asarray(getattr(top, f)).dtype, np.floating)})
        kw["velocities"] = _v0(np.asarray(top.masses),
                               np.asarray(top.dof_mask), cfg.temp_target)
        super().__init__(top, cfg, x0, **kw)


class _PortMd(TShoot.MdSim):
    def __init__(self, top, cfg, x0, **kw):
        kw["velocities"] = _v0(top.masses.numpy(), top.dof_mask.numpy(),
                               cfg.temp_target)
        super().__init__(top, cfg, x0, **kw)


def test_dock_md_matches_reference(fixture, monkeypatch):
    """One shot of 32 steps of 2 fs (chunks of 2, 16 trace points) with
    the ligand at the fixture's site, on a cut of the receptor within
    12 A of it (62 atoms, 54 bonds; 8 A holds 5 atoms), float64,
    Langevin-middle at gamma 0, FIRE 200 at construction, flexible X-H:
    the interaction trace, the closest approach and ligand_final equal the
    reference's."""
    radius = 12.0
    monkeypatch.setattr(JShoot, "MdSim", _RefMd)
    monkeypatch.setattr(TShoot, "MdSim", _PortMd)
    mol_j, mol_t = fixture["mols"]
    c = np.asarray(fixture["site"][1].site_center)
    rec_j = JPocket.cut(mol_j, c, radius).mol.to_spec(strict=False)
    rec_t = MoleculePocket.cut(mol_t, c, radius).mol.to_spec(strict=False)
    kw = dict(site_center=c, n_steps=32)
    a = JShoot.dock_md(rec_j, fixture["lig"][0], cfg_overrides=dict(
        dtype="float64", integrator=JInt.langevin_middle(gamma=0.0)), **kw)
    b = TShoot.dock_md(rec_t, fixture["lig"][1], cfg_overrides=dict(
        dtype="float64", integrator=Integrator.langevin_middle(gamma=0.0)),
        device="cpu", **kw)
    ta, tb = a.interaction_trace, b.interaction_trace
    assert tb.shape == ta.shape == (16,)
    assert np.isfinite(tb).all() and np.abs(tb).max() > 0.0
    np.testing.assert_allclose(tb, ta, rtol=0,
                               atol=1e-8 * float(np.abs(ta).max()))
    np.testing.assert_allclose(b.ligand_final, a.ligand_final, rtol=0,
                               atol=1e-6)
    assert b.min_site_distance == pytest.approx(a.min_site_distance,
                                                rel=1e-9)
    assert b.best_interaction_kcal == float(tb.min())
    assert b.final_interaction_kcal == float(tb[-1])


def test_dock_md_multi_shots_like_reference(fixture, monkeypatch):
    """dock_md_multi runs its shots one after another with the reference's
    approach vectors, seeds and site, and returns them best first."""
    calls = {"ref": [], "port": []}

    def fake(side, mod):
        def dock_md(rec, lig, site_center=None, approach=None, seed=0,
                    **kw):
            calls[side].append((np.asarray(site_center), approach, seed,
                                kw))
            return mod.ShootResult(float(-seed), 0.0, np.zeros(1), 1.0)
        return dock_md

    monkeypatch.setattr(JShoot, "dock_md", fake("ref", JShoot))
    monkeypatch.setattr(TShoot, "dock_md", fake("port", TShoot))
    rec, lig = fixture["rec"][1], fixture["lig"][1]
    c = fixture["site"][1].site_center
    ref = JShoot.dock_md_multi(rec, lig, n_shots=5, site_center=c,
                               n_steps=8)
    got = TShoot.dock_md_multi(rec, lig, n_shots=5, site_center=c,
                               n_steps=8, device="cpu")
    assert [r.best_interaction_kcal for r in got] == \
        [r.best_interaction_kcal for r in ref] == [-4.0, -3.0, -2.0, -1.0,
                                                    0.0]
    assert len(calls["port"]) == len(calls["ref"]) == 5
    for (cj, aj, sj, kj), (ct, at, st, kt) in zip(calls["ref"],
                                                  calls["port"]):
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(at, aj)
        assert st == sj and kt == {**kj, "device": "cpu"}


_DEFAULT_DEVICE_CALLS = {
    "DockingSetup.new": lambda f: DockingSetup.new(
        f["rec"][1], f["site"][1]),
    "score_poses": lambda f: score_poses(
        f["setup"][1], f["lig"][1], f["poses"][:4]),
    "find_optimal_pose": lambda f: find_optimal_pose(
        f["setup"][1], f["lig"][1], f["poses"][:4]),
    "dock_md": lambda f: TShoot.dock_md(f["rec"][1], f["lig"][1],
                                        n_steps=2),
    "density_from_atoms": lambda f: TD.density_from_atoms(
        f["lig"][1].positions, np.ones(33), (20.0,) * 3, (8, 8, 8)),
    "density_map_from_sf": lambda f: TD.density_map_from_sf(
        [1], [0], [0], amp=[1.0], phase=[0.0], grid=(8, 8, 8)),
    "sample_density": lambda f: TD.sample_density(
        TD.DensityMap(np.zeros((4, 4, 4)), (4.0,) * 3), np.zeros((2, 3))),
    "molecular_surface": lambda f: molecular_surface(f["lig"][1].positions),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_entry_point_defaults_to_the_card(fixture, name, monkeypatch):
    """Called without a device, each entry point of the slice takes the
    CUDA card, and without one raises (the card is hidden, so the check
    runs on any host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CALLS[name](fixture)
