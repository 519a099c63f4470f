"""Port parity of screening and its molecule stack (molchanica_tpu_torch.
molecules.characterization, .smiles, .embed, .components, .tautomers,
.conformers, .alignment, and .screening) against molchanica_tpu's, on the
CPU, on SMILES of the committed therapeutic CSVs and the committed pocket
ligand (ibuprofen).

Tolerances:
- characterize, find_rings, find_rotatable_bonds, from_smiles (elements,
  bonds, orders, charges, embedded positions), to_smiles, decompose,
  component_summary, enumerate_tautomers, kabsch, rigid_align, the
  ConformerSet methods, auto_pharmacophore's JSON: host numpy copies,
  held exactly.
- Pharmacophore.score and score_breakdown: 1e-12.
- generate_conformers: the candidates bit for bit (before sorting); the
  float32 vacuum energies within 1e-5 of the sum of each conformer's
  |terms| (bond, angle, dihedral, lj, coulomb); with both packages'
  MdConfig set to float64 (the reference's float32 arrays and its float32
  topology cast to float64, as the port casts its own), minimize_best's
  conformer and energies within rel 1e-8.
- flexible_align on CCCO in float64 at Langevin gamma 0 (both MdSims from
  the same numpy velocities, FIRE 200 at construction), 20 steps:
  positions within 1e-6 A.
- screen_ligs over 6 library ligands (fumaric acid among them, whose '/'
  atoms typing refuses) from a directory of SDF files, in float64: names
  and conformer indices equal, scores within 1e-9.
"""
import copy
import csv
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.io.sdf import read_sdf as j_read_sdf
from molchanica_tpu.md import config as JCfg
from molchanica_tpu.md import engine as JEngine
from molchanica_tpu.md import minimize as JMin
from molchanica_tpu.molecules import alignment as JA
from molchanica_tpu.molecules import characterization as JChar
from molchanica_tpu.molecules import components as JComp
from molchanica_tpu.molecules import conformers as JConf
from molchanica_tpu.molecules import smiles as JS
from molchanica_tpu.molecules import spec as JSpec
from molchanica_tpu.molecules import tautomers as JTaut
from molchanica_tpu.screening import pharmacophore as JPh
from molchanica_tpu.screening import screen as JScreen
from molchanica_tpu_torch.constants import ACCEL_FACTOR, KB
from molchanica_tpu_torch.io import read_sdf, write_sdf
from molchanica_tpu_torch.md import config as TCfg
from molchanica_tpu_torch.md import engine as TEngine
from molchanica_tpu_torch.molecules import alignment as TA
from molchanica_tpu_torch.molecules import characterization as TChar
from molchanica_tpu_torch.molecules import components as TComp
from molchanica_tpu_torch.molecules import conformers as TConf
from molchanica_tpu_torch.molecules import embed as TEmbed
from molchanica_tpu_torch.molecules import smiles as TS
from molchanica_tpu_torch.molecules import tautomers as TTaut
from molchanica_tpu_torch.screening import pharmacophore as TPh
from molchanica_tpu_torch.screening import screen as TScreen
from molchanica_tpu_torch.topology import TENSOR_FIELDS as TOP_FIELDS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGAND_SDF = os.path.join(ROOT, "molchanica_tpu", "systems", "data",
                          "pocket_ligand.sdf")
CSV_GLOB = os.path.join(ROOT, "molchanica_tpu", "therapeutic", "data",
                        "*.csv")

FUMARIC = "OC(=O)/C=C/C(=O)O"
CHAR_SMILES = [
    "CC(C)NCC(O)COc1cccc2[nH]ccc12", "CC[N+](=O)[O-]",
    "CN(C)CCCN1c2ccccc2Sc2ccc(Cl)cc21",
    "CN(Cc1cnc2nc(N)nc(N)c2n1)c1ccc(C(=O)NC(CCC(=O)O)C(=O)O)cc1",
    "NS(=O)(=O)c1cc2c(cc1Cl)N=CNS2(=O)=O", "Nc1ccc(cc1)S(=O)(=O)Nc1cc(C)on1",
    "O=c1[nH]cnc2c1ncn2C1OC(CO)C(O)C1O", FUMARIC, "CC(=O)C",
    "COc1ccc(CCN(C)CCCC(C#N)(C(C)C)c2ccc(OC)c(OC)c2)cc1OC",
    "c1ccc2ncccc2c1",
]
CONF_SMILES = ["CC(C)NCC(O)COc1cccc2[nH]ccc12", "CCCCCCO"]
SCREEN_SMILES = [FUMARIC, "CCO", "OC(=O)c1ccc(Cl)cc1", "CN1CCCC1c1cccnc1",
                 "CCCCCCO", "Oc1ccc(Cl)cc1"]
ALIGN_SMILES = "CCCO"
ENERGY_TOL = 1e-5


def _library():
    out = set()
    for path in sorted(glob.glob(CSV_GLOB)):
        with open(path) as fh:
            out.update(row["smiles"] for row in csv.DictReader(fh))
    return out


@pytest.fixture(scope="module")
def mols():
    """Each test SMILES through both packages' from_smiles (the JAX side
    once per module)."""
    lib = _library()
    names = sorted(set(CHAR_SMILES + CONF_SMILES + SCREEN_SMILES
                       + [ALIGN_SMILES]))
    missing = [s for s in names if s not in lib]
    assert not missing, missing
    return {s: (JS.from_smiles(s), TS.from_smiles(s)) for s in names}


@pytest.fixture(scope="module")
def ligand():
    return j_read_sdf(LIGAND_SDF), read_sdf(LIGAND_SDF)


def _f64(monkeypatch):
    """Both packages' conformer energies in float64: the port through its
    MdConfig, the reference through its float32 arrays and topology."""
    port_cfg = TConf.MdConfig
    monkeypatch.setattr(TConf, "MdConfig",
                        lambda **kw: port_cfg(**{**kw, "dtype": "float64"}))
    ref_cfg = JCfg.MdConfig
    monkeypatch.setattr(JCfg, "MdConfig",
                        lambda **kw: ref_cfg(**{**kw, "dtype": "float64"}))
    monkeypatch.setattr(jnp, "float32", jnp.float64)
    dus = jax.lax.dynamic_update_slice
    monkeypatch.setattr(jax.lax, "dynamic_update_slice",
                        lambda op, up, idx: dus(op, up.astype(op.dtype), idx))
    asm = JSpec.assemble_system

    def asm64(*a, **kw):
        asys = asm(*a, **{**kw, "dtype": np.float32})
        return dataclasses.replace(asys, topology=_top64(asys.topology))

    monkeypatch.setattr(JSpec, "assemble_system", asm64)


def _top64(top):
    """A JAX topology's floating fields, float32 values, in float64: the
    port assembles in float32 and casts its topology the same way."""
    return top.replace(**{
        f: jnp.asarray(np.asarray(getattr(top, f)), np.float64)
        for f in TOP_FIELDS
        if np.issubdtype(np.asarray(getattr(top, f)).dtype, np.floating)})


# --------------------------------------------------------------------------
# characterization, SMILES, embedding, components, tautomers

@pytest.mark.parametrize("smi", CHAR_SMILES)
def test_characterize_matches_reference(mols, smi):
    mj, mt = mols[smi]
    a, b = JChar.characterize(mj), TChar.characterize(mt)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    np.testing.assert_array_equal(a.feature_vector(), b.feature_vector())
    rings = TChar.find_rings(mt.n_atoms, mt.bonds)
    assert rings == JChar.find_rings(mj.n_atoms, mj.bonds)
    assert TChar.find_rotatable_bonds(
        mt.elements, mt.bonds, mt.bond_orders, rings, mt.adjacency()) == \
        JChar.find_rotatable_bonds(mj.elements, mj.bonds, mj.bond_orders,
                                   rings, mj.adjacency())


@pytest.mark.parametrize("smi", CHAR_SMILES)
def test_from_smiles_matches_reference(mols, smi):
    """Elements ('/' atoms included), bonds, orders, charges and the
    embedded positions; to_smiles with and without hydrogens."""
    mj, mt = mols[smi]
    assert mt.elements == mj.elements and mt.bonds == mj.bonds
    assert mt.bond_orders == mj.bond_orders
    assert mt.formal_charges == mj.formal_charges and mt.name == mj.name
    np.testing.assert_allclose(mt.positions, mj.positions, rtol=0,
                               atol=1e-12)
    if smi == FUMARIC:
        assert mt.elements.count("/") == 2
    for include_h in (False, True):
        assert TS.to_smiles(mt, include_h) == JS.to_smiles(mj, include_h)


def test_embed_matches_reference(mols):
    """embed_3d at another seed and iteration count, and
    ensure_coordinates leaving real geometry alone."""
    mj, mt = mols[CHAR_SMILES[0]]
    from molchanica_tpu.molecules import embed as JEmbed
    np.testing.assert_array_equal(TEmbed.embed_3d(mt, seed=3, n_iters=50),
                                  JEmbed.embed_3d(mj, seed=3, n_iters=50))
    x = mt.positions.copy()
    assert TEmbed.ensure_coordinates(mt, seed=5).positions is mt.positions
    np.testing.assert_array_equal(mt.positions, x)


@pytest.mark.parametrize("smi", ["CC(C)NCC(O)COc1cccc2[nH]ccc12", "CC(=O)C",
                                 "O=c1[nH]cnc2c1ncn2C1OC(CO)C(O)C1O",
                                 "CN(Cc1cnc2nc(N)nc(N)c2n1)c1ccc(C(=O)NC("
                                 "CCC(=O)O)C(=O)O)cc1"])
def test_components_and_tautomers_match_reference(mols, smi):
    mj, mt = mols[smi]
    assert [dataclasses.asdict(c) for c in TComp.decompose(mt)] == \
        [dataclasses.asdict(c) for c in JComp.decompose(mj)]
    assert TComp.component_summary(mt) == JComp.component_summary(mj)
    tt, tj = TTaut.enumerate_tautomers(mt), JTaut.enumerate_tautomers(mj)
    assert len(tt) == len(tj)
    for a, b in zip(tt, tj):
        assert a.bonds == b.bonds and a.bond_orders == b.bond_orders
        np.testing.assert_array_equal(a.positions, b.positions)


# --------------------------------------------------------------------------
# conformers

@pytest.fixture(scope="module")
def ref_conformers(mols):
    return {s: JConf.generate_conformers(mols[s][0], n_conformers=8, seed=1)
            for s in CONF_SMILES}


def _rows(a):
    """The conformers of [C, n, 3] as sorted rows (order-free compare)."""
    flat = np.asarray(a, np.float32).reshape(len(a), -1)
    return flat[np.lexsort(flat.T[::-1])]


@pytest.mark.parametrize("smi", CONF_SMILES)
def test_conformers_match_reference(mols, ref_conformers, smi):
    """The candidates bit for bit; each float32 energy within ENERGY_TOL
    of its conformer's sum of |terms|; the port's ranking by them."""
    ref = ref_conformers[smi]
    mt = mols[smi][1]
    prep = TConf.prepare_conformers(mt, n_conformers=8, seed=1)
    assert prep.torsions == ref.torsions and len(ref.torsions) >= 2
    np.testing.assert_array_equal(_rows(prep.coords), _rows(ref.coords))
    e, terms = TConf.conformer_energies(prep, torch.device("cpu"))
    assert e.dtype == torch.float32
    scale = sum(v.abs() for v in terms.values()).numpy()
    flat = prep.coords.reshape(len(prep.coords), -1)
    for k in range(len(ref.coords)):
        row = ref.coords[k].astype(np.float32).reshape(-1)
        j = int(np.nonzero((flat == row).all(axis=1))[0][0])
        assert abs(float(e[j]) - float(ref.energies[k])) \
            <= ENERGY_TOL * scale[j], (k, j)
    got = TConf.generate_conformers(mt, n_conformers=8, seed=1,
                                    device="cpu")
    assert np.all(np.diff(got.energies) >= 0)
    np.testing.assert_array_equal(_rows(got.coords), _rows(ref.coords))


def test_minimize_best_matches_reference_float64(mols, monkeypatch):
    """The reference's FIRE runs as one jitted program (its final force
    call too, which it otherwise dispatches op by op: ~6 s of compiles on
    the CPU for the same float64 arithmetic)."""
    _f64(monkeypatch)
    fire = JMin.fire_minimize
    monkeypatch.setattr(
        JMin, "fire_minimize", lambda force_fn, *a, **kw: jax.jit(
            lambda *b: fire(force_fn, *b, **kw))(*a))
    mj, mt = mols["CCCCCCO"]
    ref = JConf.generate_conformers(mj, n_conformers=4, seed=2,
                                    minimize_best=True)
    got = TConf.generate_conformers(mt, n_conformers=4, seed=2,
                                    minimize_best=True, device="cpu")
    assert ref.energies.dtype == got.energies.dtype == np.float64
    np.testing.assert_allclose(got.coords[0], ref.coords[0], rtol=0,
                               atol=1e-8 * np.abs(ref.coords[0]).max())
    np.testing.assert_allclose(got.energies, ref.energies, rtol=1e-8)
    assert got.energies[0] <= got.energies[1]


def test_conformer_set_methods_match_reference(ref_conformers):
    """The ConformerSet methods on the same arrays."""
    ref = ref_conformers[CONF_SMILES[0]]
    got = TConf.ConformerSet(coords=ref.coords.copy(),
                             energies=ref.energies.copy(),
                             torsions=list(ref.torsions))
    np.testing.assert_array_equal(got.best, ref.best)
    for t in (298.15, 600.0):
        np.testing.assert_array_equal(got.boltzmann_weights(t),
                                      ref.boltzmann_weights(t))
        np.testing.assert_array_equal(got.summary_features(t),
                                      ref.summary_features(t))
    np.testing.assert_array_equal(got.radii_of_gyration(),
                                  ref.radii_of_gyration())
    for thr in (0.3, 1.0):
        a, b = got.deduplicate(thr), ref.deduplicate(thr)
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.energies, b.energies)


# --------------------------------------------------------------------------
# alignment

def test_kabsch_and_rigid_align_match_reference(mols, ligand):
    rng = np.random.default_rng(11)
    p = rng.normal(size=(12, 3)) * 3.0
    q = rng.normal(size=(12, 3)) * 3.0
    w = rng.uniform(0.5, 2.0, 12)
    for weights in (None, w):
        for a, b in zip(TA.kabsch(p, q, weights), JA.kabsch(p, q, weights)):
            np.testing.assert_array_equal(a, b)
    assert TA.kabsch_rmsd(p, q) == JA.kabsch_rmsd(p, q)
    lj, lt = ligand
    for smi in ("CC(C)NCC(O)COc1cccc2[nH]ccc12", "CC(=O)C"):
        mj, mt = mols[smi]
        assert TA._feature_pairs(mt, lt) == JA._feature_pairs(mj, lj)
        a, b = TA.rigid_align(mt, lt), JA.rigid_align(mj, lj)
        np.testing.assert_array_equal(a.positions, b.positions)
        assert a.rmsd == b.rmsd and a.matched_pairs == b.matched_pairs
    # fewer than 3 correspondences: the orientation search
    mj, mt = mols["CCO"]
    a, b = TA.rigid_align(mt, lt), JA.rigid_align(mj, lj)
    assert a.matched_pairs == b.matched_pairs == []
    np.testing.assert_array_equal(a.positions, b.positions)
    assert a.rmsd == b.rmsd


def _v0(masses, dof_mask, temp):
    """Maxwell-Boltzmann velocities at `temp` drawn with numpy from a fixed
    seed: both packages' MdSims start from these."""
    rng = np.random.default_rng(7)
    m = np.maximum(np.asarray(masses, np.float64), 1e-6)
    sd = np.sqrt(KB * temp * ACCEL_FACTOR / m)
    return rng.normal(size=(m.size, 3)) * sd[:, None] \
        * np.asarray(dof_mask, np.float64)[:, None]


class _RefMd(JEngine.MdSim):
    """The reference's MdSim on its float32 topology cast to float64 (as
    the port's MdSim casts its own), from _v0's velocities."""
    def __init__(self, top, cfg, x0, **kw):
        top = _top64(top)
        kw["velocities"] = _v0(np.asarray(top.masses),
                               np.asarray(top.dof_mask), cfg.temp_target)
        super().__init__(top, cfg, x0, **kw)


class _PortMd(TEngine.MdSim):
    def __init__(self, top, cfg, x0, **kw):
        kw["velocities"] = _v0(top.masses.numpy(), top.dof_mask.numpy(),
                               cfg.temp_target)
        super().__init__(top, cfg, x0, **kw)


def test_flexible_align_matches_reference(mols, monkeypatch):
    """CCCO pulled onto a rotated, perturbed copy of itself: float64,
    Langevin gamma 0, FIRE 200 at construction, 20 steps of 1 fs. The
    reference's step scan runs at its own unroll override of 1 (by
    default it unrolls 8 steps below 512 atoms, which only costs XLA
    compile time here)."""
    monkeypatch.setenv("MOLCHANICA_SCAN_UNROLL", "1")
    def cfg64(mod):
        cls = mod.MdConfig
        return lambda **kw: cls(**kw).replace(
            dtype="float64", integrator=mod.Integrator.langevin_middle(0.0))

    monkeypatch.setattr(JCfg, "MdConfig", cfg64(JCfg))
    monkeypatch.setattr(TCfg, "MdConfig", cfg64(TCfg))
    monkeypatch.setattr(JEngine, "MdSim", _RefMd)
    monkeypatch.setattr(TEngine, "MdSim", _PortMd)
    mj, mt = mols[ALIGN_SMILES]
    rng = np.random.default_rng(5)
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    tmpl_x = mj.positions @ rot.T + rng.normal(0.0, 0.3, mj.positions.shape)
    tj, tt = JS.from_smiles("CCCO"), TS.from_smiles("CCCO")
    tj.positions, tt.positions = tmpl_x.copy(), tmpl_x.copy()
    ref = JA.flexible_align(mj, tj, n_steps=20)
    got = TA.flexible_align(mt, tt, n_steps=20, device="cpu")
    assert got.matched_pairs == ref.matched_pairs
    assert len(got.matched_pairs) >= 3
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=1e-6)
    assert abs(got.rmsd - ref.rmsd) < 1e-6


# --------------------------------------------------------------------------
# pharmacophores and screening

@pytest.fixture(scope="module")
def pharmacophores(ligand):
    lj, lt = ligand
    return JPh.auto_pharmacophore(lj), TPh.auto_pharmacophore(lt)


def test_auto_pharmacophore_matches_reference(pharmacophores):
    pj, pt = pharmacophores
    assert pt.to_json() == pj.to_json()
    assert len(pt.features) == 6 and pt.summary() == pj.summary()
    back = TPh.Pharmacophore.from_json(pj.to_json())
    assert back.to_json() == pj.to_json()


def _with_relations(ph, module):
    """A copy of ph with an AND and an OR relation and two exclusion
    spheres, to reach every branch of the matcher."""
    d = module.Pharmacophore.from_json(ph.to_json())
    d.feature_relations = [module.FeatureRelation("and", 0, 1),
                           module.FeatureRelation("or", 2, 3)]
    c = np.mean([f.position for f in d.features], axis=0)
    d.exclusion_spheres = [(c + 4.0, 2.0), (c - 3.0, 1.5)]
    return d


@pytest.mark.parametrize("smi", ["CC(C)NCC(O)COc1cccc2[nH]ccc12",
                                 "Nc1ccc(cc1)S(=O)(=O)Nc1cc(C)on1",
                                 "CC[N+](=O)[O-]", FUMARIC])
def test_score_breakdown_matches_reference(mols, pharmacophores, smi):
    """Scores of the molecule moved about the pharmacophore's centroid,
    with the auto model and with relations and exclusion spheres."""
    pj, pt = pharmacophores
    models = [(pj, pt), (_with_relations(pj, JPh), _with_relations(pt, TPh))]
    mj, mt = (copy.copy(m) for m in mols[smi])
    rng = np.random.default_rng(len(smi))
    c = np.mean([f.position for f in pj.features], axis=0)
    for _ in range(3):
        x = mt.positions - mt.positions.mean(0) + c \
            + rng.normal(0.0, 1.0, 3)
        mj.positions, mt.positions = x.copy(), x.copy()
        for a, b in models:
            ra, rb = a.score_breakdown(mj), b.score_breakdown(mt)
            assert abs(ra.total - rb.total) <= 1e-12
            np.testing.assert_allclose(rb.feat_scores, ra.feat_scores,
                                       rtol=0, atol=1e-12)
            assert rb.feat_matched == ra.feat_matched
            assert (rb.match_fraction, rb.clash_fraction) == \
                (ra.match_fraction, ra.clash_fraction)
            assert abs(b.score(mt) - a.score(mj)) <= 1e-12


def test_screen_ligs_matches_reference_float64(mols, pharmacophores,
                                               monkeypatch, tmp_path):
    """Six library ligands written as SDF files by the port and screened
    from the directory by both packages in float64. Fumaric acid's '/'
    atoms fail typing, so both score it on its own positions."""
    for k, smi in enumerate(SCREEN_SMILES):
        write_sdf(mols[smi][1], str(tmp_path / f"lig{k:02d}.sdf"))
    _f64(monkeypatch)
    pj, pt = pharmacophores
    ref = JScreen.screen_ligs(pj, str(tmp_path))
    got = TScreen.screen_ligs(pt, str(tmp_path), device="cpu")
    assert [h.name for h in got] == [h.name for h in ref]
    assert sorted(h.name for h in got) == sorted(SCREEN_SMILES)
    for a, b in zip(got, ref):
        assert abs(a.score - b.score) <= 1e-9, a.name
        assert a.conformer == b.conformer, a.name
        assert a.source == b.source
        assert (a.fallback is not None) == (a.name == FUMARIC), a.name
    assert [h.fallback for h in got if h.fallback] == ["KeyError('/')"]
    with pytest.raises(KeyError):
        JConf.generate_conformers(mols[FUMARIC][0], n_conformers=8)


def test_device_failure_is_not_scored_as_a_fallback(mols, pharmacophores,
                                                     monkeypatch):
    """An error of the device work stops the screen: only the host
    preparation falls back to a ligand's own positions."""
    def broken(prep, device, minimize_best=False):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(TScreen, "rank_conformers", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        TScreen.screen_ligs(pharmacophores[1], [mols["CCO"][1]],
                            device="cpu")
    hits = TScreen.screen_ligs(pharmacophores[1], [mols[FUMARIC][1]],
                               device="cpu")
    assert hits[0].fallback == "KeyError('/')"


_DEFAULT_DEVICE_CALLS = {
    "generate_conformers": lambda m, lig, ph: TConf.generate_conformers(m),
    "flexible_align": lambda m, lig, ph: TA.flexible_align(m, lig),
    "screen_ligs": lambda m, lig, ph: TScreen.screen_ligs(ph, [m]),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_entry_point_defaults_to_the_card(mols, ligand, pharmacophores,
                                          name, monkeypatch):
    """Called without a device, each entry point of the slice takes the
    CUDA card, and without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CALLS[name](mols["CCO"][1], ligand[1],
                                    pharmacophores[1])


@pytest.mark.slow
def test_reference_flexible_align_ends_above_its_rigid_rmsd():
    """Witness of a reference behaviour the port copies (~25 s): on
    phenytoin, the library's best hit after ibuprofen itself, the JAX
    package's flexible_align at its defaults ends above the rigid
    prealignment's matched-pair RMSD, because FIRE at construction runs
    without the pull (CPU, float32: rigid 1.5486 A, 2.5968 after FIRE,
    1.9374 after the 400 pulled steps in the port). The port ends within
    0.05 A of it and above the rigid RMSD too."""
    lj = j_read_sdf(LIGAND_SDF)
    smi = "O=C1NC(=O)C(c2ccccc2)(c2ccccc2)N1"
    assert smi in _library()
    ref = JA.flexible_align(JS.from_smiles(smi), lj)
    rigid = JA.rigid_align(JS.from_smiles(smi), lj)
    got = TA.flexible_align(TS.from_smiles(smi), read_sdf(LIGAND_SDF),
                            device="cpu")
    print(f"rigid {rigid.rmsd:.4f} reference {ref.rmsd:.4f} port "
          f"{got.rmsd:.4f} A")
    assert ref.rmsd > rigid.rmsd and got.rmsd > rigid.rmsd
    assert abs(got.rmsd - ref.rmsd) < 0.05
