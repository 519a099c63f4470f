"""Port parity: the host-side molecule and force-field chain of
molchanica_tpu_torch (elements, MoleculeCommon, bond inference, the PDB and
SDF readers and writers, MoleculePocket, the Amber parsers, the GAFF2
subset, GAFF2 typing, Gasteiger charges and assign_params / to_spec)
against molchanica_tpu's, on the committed pocket fixture (an 804-atom
receptor and ibuprofen).

The port's copies run the reference's numpy code, so every stage is held
exactly: elements, positions and bonds; the GAFF types; the charges within
1e-12; every MolSpec field and term list. Each stage is compared on its
own, so a difference shows where it starts.
"""
import dataclasses
import os

import numpy as np
import pytest

from molchanica_tpu.ff import amber_dat as JA
from molchanica_tpu.ff import params as JParams
from molchanica_tpu.ff.charges import gasteiger_charges as j_charges
from molchanica_tpu.ff.typing_gaff import assign_gaff_types as j_types
from molchanica_tpu.ff.typing_gaff import fold_type as j_fold
from molchanica_tpu.io.pdb import read_pdb as j_read_pdb
from molchanica_tpu.io.pdb import write_pdb as j_write_pdb
from molchanica_tpu.io.sdf import read_sdf as j_read_sdf
from molchanica_tpu.io.sdf import write_sdf as j_write_sdf
from molchanica_tpu.molecules import elements as JE
from molchanica_tpu.molecules.bond_inference import infer_bonds as j_infer
from molchanica_tpu.molecules.pocket import MoleculePocket as JPocket
from molchanica_tpu_torch.ff import amber_dat as TA
from molchanica_tpu_torch.ff import params as TParams
from molchanica_tpu_torch.ff.charges import gasteiger_charges
from molchanica_tpu_torch.ff.typing_gaff import assign_gaff_types, fold_type
from molchanica_tpu_torch.io import read_pdb, read_sdf, write_pdb, write_sdf
from molchanica_tpu_torch.molecules import elements as TE
from molchanica_tpu_torch.molecules.bond_inference import infer_bonds
from molchanica_tpu_torch.molecules.pocket import MoleculePocket

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FDIR = os.path.join(ROOT, "molchanica_tpu", "systems", "data")
FPDB = os.path.join(FDIR, "pocket_fixture.pdb")
FSDF = os.path.join(FDIR, "pocket_ligand.sdf")

MOL_FIELDS = ("elements", "bonds", "bond_orders", "atom_names", "res_names",
              "res_ids", "chains", "formal_charges", "name", "hetero")


@pytest.fixture(scope="module")
def mols():
    """Both packages' receptor and ligand MoleculeCommon, read from the
    fixture files."""
    return dict(receptor=(j_read_pdb(FPDB), read_pdb(FPDB)),
                ligand=(j_read_sdf(FSDF), read_sdf(FSDF)))


@pytest.fixture(scope="module")
def specs(mols):
    """to_spec(strict=False) of each molecule in both packages."""
    return {k: (a.to_spec(strict=False), b.to_spec(strict=False))
            for k, (a, b) in mols.items()}


def _same_mol(a, b):
    np.testing.assert_array_equal(np.asarray(b.positions),
                                  np.asarray(a.positions))
    for f in MOL_FIELDS:
        assert getattr(b, f) == getattr(a, f), f
    assert (a.charges is None) == (b.charges is None)


def _same_spec(a, b):
    """Every MolSpec field equal: the arrays bit for bit, the term lists
    and flags as values."""
    da, db = vars(a), vars(b)
    assert da.keys() == db.keys()
    for k, v in da.items():
        if isinstance(v, np.ndarray):
            assert db[k].dtype == v.dtype, k
            np.testing.assert_array_equal(db[k], v, err_msg=k)
        else:
            assert db[k] == v, k


@pytest.mark.parametrize("name", ["receptor", "ligand"])
def test_readers_equal_reference(mols, name):
    """read_pdb / read_sdf: equal elements, positions, bonds (and orders,
    names, residues, formal charges); the fixture's sizes."""
    a, b = mols[name]
    _same_mol(a, b)
    assert b.n_atoms == {"receptor": 804, "ligand": 33}[name]
    assert len(b.bonds) > 0


@pytest.mark.parametrize("name", ["receptor", "ligand"])
def test_writers_equal_reference(mols, name, tmp_path):
    """write_pdb / write_sdf give the reference's text, and reading it
    back gives the same molecule in both packages."""
    a, b = mols[name]
    write, j_write, read, j_read = (
        (write_pdb, j_write_pdb, read_pdb, j_read_pdb) if name == "receptor"
        else (write_sdf, j_write_sdf, read_sdf, j_read_sdf))
    text = write(b)
    assert text == j_write(a)
    path = tmp_path / ("m.pdb" if name == "receptor" else "m.sdf")
    write(b, str(path))
    back_t, back_j = read(str(path)), j_read(str(path))
    np.testing.assert_array_equal(back_t.positions, back_j.positions)
    assert back_t.bonds == back_j.bonds == b.bonds
    assert back_t.elements == b.elements


def test_infer_bonds_equals_reference(mols):
    """Distance-based bonds on the fixture's atoms: the reference's list,
    and infer_bonds() on the molecule."""
    for a, b in mols.values():
        got = infer_bonds(b.elements, b.positions)
        assert got == j_infer(a.elements, a.positions)
        assert len(got) > 0
    a, b = mols["receptor"]
    m = dataclasses.replace(b)
    assert m.infer_bonds().bonds == j_infer(a.elements, a.positions)
    assert m.bond_orders is None


def test_elements_equal_reference():
    for s in ("c", "CL", " n ", "Br", "zn", "H"):
        assert TE.normalize_symbol(s) == JE.normalize_symbol(s)
        assert TE.element_mass(s) == JE.element_mass(s)
    assert TE.COVALENT_RADII == JE.COVALENT_RADII
    assert TE.ELEMENT_MASSES == JE.ELEMENT_MASSES
    assert TE.VDW_RADII == JE.VDW_RADII
    with pytest.raises(ValueError):
        TE.normalize_symbol(" ")


@pytest.mark.parametrize("name", ["receptor", "ligand"])
def test_gaff_types_equal_reference(mols, name):
    """GAFF2 types from the molecule's bonds and orders (the receptor's
    from CONECT records, the ligand's from the SDF with its orders)."""
    a, b = mols[name]
    got = assign_gaff_types(b.elements, b.bonds, b.bond_orders)
    assert got == j_types(a.elements, a.bonds, a.bond_orders)
    assert len(set(got)) > 3
    assert [fold_type(t) for t in got] == [j_fold(t) for t in got]


@pytest.mark.parametrize("name", ["receptor", "ligand"])
def test_gasteiger_charges_equal_reference(mols, name):
    a, b = mols[name]
    got = gasteiger_charges(b.elements, b.bonds, b.bond_orders,
                            b.formal_charges)
    ref = j_charges(a.elements, a.bonds, a.bond_orders, a.formal_charges)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert abs(float(got.sum()) - float(np.sum(b.formal_charges or 0))) \
        < 1e-9


@pytest.mark.parametrize("name", ["receptor", "ligand"])
def test_to_spec_equals_reference(specs, name):
    """to_spec(strict=False): every MolSpec field and term list equal."""
    a, b = specs[name]
    _same_spec(a, b)
    assert b.n_atoms == {"receptor": 804, "ligand": 33}[name]
    assert len(b.bonds) and len(b.angles) and len(b.dihedrals)


def test_strict_raises_like_reference(mols):
    """A type the GAFF2 subset lacks: strict assignment raises
    MissingParameter in both packages."""
    a, b = mols["ligand"]
    types = ["zz"] + assign_gaff_types(b.elements, b.bonds,
                                       b.bond_orders)[1:]
    params = TParams.FfParamSet.new_default().small_mol
    args = (b.elements, types, np.zeros(b.n_atoms), b.positions, b.bonds)
    with pytest.raises(TParams.MissingParameter):
        TParams.assign_params(*args, params, strict=True)
    with pytest.raises(JParams.MissingParameter):
        JParams.assign_params(*args, JParams.FfParamSet.new_default()
                              .small_mol, strict=True)
    _same_spec(JParams.assign_params(*args, JParams.FfParamSet.new_default()
                                     .small_mol, strict=False),
               TParams.assign_params(*args, params, strict=False))


FRCMOD = """test frcmod
MASS
c3 12.010         0.878
zz 14.000

BOND
c3-zz  300.0    1.470
ca-ca  478.4    1.387

ANGL
c3-zz-c3   63.0     110.0

DIHE
X -c3-zz-X     9    1.400       0.000           3.000
c3-c3-zz-c3    1    0.100       0.000          -3.000
c3-c3-zz-c3    1    0.200     180.000           2.000

IMPR
X -X -zz-o          1.1          180.0         2.0

NONB
  zz          1.8240  0.1700
"""

DAT = """test dat
c3 12.010         0.878
hc 1.008          0.135

c3  hc

c3-hc  330.6    1.097
c3-c3  300.9    1.538

hc-c3-hc   39.4     107.58

X -c3-c3-X     9    1.400       0.000           3.000

X -X -c -o          1.1          180.0         2.0

  hw  ow  0000.     0000.                                4.  flag for h-bond

hc  ha

MOD4      RE
  c3          1.9080  0.1094
  hc          1.4870  0.0157
END
"""


def test_amber_parsers_equal_reference():
    """parse_frcmod / parse_dat (multi-term dihedrals, wildcards, the
    equivalence and MOD4 sections), the lookups, merge_params and the
    built-in GAFF2 subset: the reference's values."""
    for parse in ("parse_frcmod", "parse_dat"):
        text = FRCMOD if parse == "parse_frcmod" else DAT
        a, b = getattr(JA, parse)(text), getattr(TA, parse)(text)
        assert dataclasses.asdict(b) == dataclasses.asdict(a), parse
        assert len(b.bonds) and len(b.dihedrals) and len(b.nonbonded)
    fr = TA.parse_frcmod(FRCMOD)
    assert len(fr.dihedrals[("c3", "c3", "zz", "c3")]) == 2
    assert fr.dihedral("q", "c3", "zz", "q") is not None
    assert fr.improper("c3", "c3", "zz", "o") is not None
    dat = TA.parse_dat(DAT)
    assert dat.lj("ha") == dat.lj("hc")
    assert dat.lj_sigma_eps("c3")[0] == 1.9080 * TA.RMIN2_TO_SIGMA
    merged = TParams.merge_params(dat, fr)
    assert dataclasses.asdict(merged) == dataclasses.asdict(
        JParams.merge_params(JA.parse_dat(DAT), JA.parse_frcmod(FRCMOD)))
    j_set, t_set = JParams.FfParamSet.new_default(), \
        TParams.FfParamSet.new_default()
    assert dataclasses.asdict(t_set.small_mol) == dataclasses.asdict(
        j_set.small_mol)
    assert t_set.for_mol_type("small_organic") is t_set.small_mol
    assert t_set.for_mol_type("lipid") is None


def test_pocket_equals_reference(mols):
    """MoleculePocket.from_file (center at the ligand's centroid) and cut
    (atoms within the radius of the center, bonds among them)."""
    lig_j, lig_t = mols["ligand"]
    pj = JPocket.from_file(FPDB, pdb_id="fixture", ligand=lig_j)
    pt = MoleculePocket.from_file(FPDB, pdb_id="fixture", ligand=lig_t)
    _same_mol(pj.mol, pt.mol)
    c_t, r_t = pt.docking_site()
    c_j, r_j = pj.docking_site()
    np.testing.assert_array_equal(c_t, c_j)
    assert r_t == r_j and 26.0 < r_t < 27.0
    assert pt.n_atoms == 804 and pt.source_pdb_id == "fixture"
    for radius in (8.0, 12.0):
        cj = JPocket.cut(pj.mol, c_j, radius)
        ct = MoleculePocket.cut(pt.mol, c_t, radius)
        _same_mol(cj.mol, ct.mol)
        np.testing.assert_array_equal(ct.parent_atom_idx, cj.parent_atom_idx)
        assert ct.radius == cj.radius == radius
