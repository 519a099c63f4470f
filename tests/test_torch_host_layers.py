"""Port parity of the host layers beside the biomolecule builders
(molchanica_tpu_torch.ff.charges_eem, .ff.charges_bcc with
.ff.data.bcc_table, .selection, .sonification, .antibody and
.drug_design.pdbbind) against molchanica_tpu's, on the CPU.

All of them are numpy on the host, so the tolerances are tight: EEM and
BCC charges within 1e-12, the waveform within 1e-12 and the WAV file's
bytes equal, selections as equal index lists with the same errors, the
PDBbind rows and release layout field by field, CDR windows equal. No
external binary runs: ANARCI's probe and run are mocked, as the JAX
package's tests leave them uninstalled.
"""
import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from molchanica_tpu import antibody as JA
from molchanica_tpu import selection as JSel
from molchanica_tpu import sonification as JSon
from molchanica_tpu.drug_design import pdbbind as JP
from molchanica_tpu.ff import charges_bcc as JB
from molchanica_tpu.ff import charges_eem as JE
from molchanica_tpu.ff.data.protein_ff14sb import \
    RESIDUE_TEMPLATES as J_TEMPLATES
from molchanica_tpu.io.mmcif import read_mmcif as j_read_mmcif
from molchanica_tpu.io.mmcif import write_mmcif as j_write_mmcif
from molchanica_tpu.molecules import common as JCommon
from molchanica_tpu.molecules.peptide import prepare_peptide as j_prepare
from molchanica_tpu.molecules.peptide_builder import build_peptide as j_build
from molchanica_tpu.molecules.smiles import from_smiles as j_from_smiles
from molchanica_tpu_torch import antibody as TA
from molchanica_tpu_torch import selection as TSel
from molchanica_tpu_torch import sonification as TSon
from molchanica_tpu_torch.drug_design import pdbbind as TP
from molchanica_tpu_torch.ff import charges_bcc as TB
from molchanica_tpu_torch.ff import charges_eem as TE
from molchanica_tpu_torch.ff.data import bcc_table as TBT
from molchanica_tpu_torch.ff.data.protein_ff14sb import \
    RESIDUE_TEMPLATES as T_TEMPLATES
from molchanica_tpu_torch.io.mmcif import read_mmcif as t_read_mmcif
from molchanica_tpu_torch.io.mmcif import write_mmcif as t_write_mmcif
from molchanica_tpu_torch.molecules import common as TCommon
from molchanica_tpu_torch.molecules.peptide import prepare_peptide as t_prepare
from molchanica_tpu_torch.molecules.peptide_builder import \
    build_peptide as t_build
from molchanica_tpu_torch.molecules.pocket import MoleculePocket
from molchanica_tpu_torch.molecules.smiles import from_smiles as t_from_smiles

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from fit_bcc import residue_system  # noqa: E402
from test_charges_bcc import _acetamide, _benzene, _methanol  # noqa: E402
from test_pdbbind import _make_release  # noqa: E402

CHARGE_TOL = 1e-12
SEQ = "ASGVLFKWPHTY"
TRASTUZUMAB_VH = (
    "EVQLVESGGGLVQPGGSLRLSCAASGFNIKDTYIHWVRQAPGKGLEWVARIYPTNGYTRYADSVKG"
    "RFTISADTSKNTAYLQMNSLRAEDTAVYYCSRWGGDGFYAMDYWGQGTLVTVSS")
# a light chain's variable domain (trastuzumab VL, public)
TRASTUZUMAB_VL = (
    "DIQMTQSPSSLSASVGDRVTITCRASQDVNTAVAWYQQKPGKAPKLLIYSASFLYSGVPSRFSGSR"
    "SGTDFTLTISSLQPEDFATYYCQQHYTTPPTFGQGTKVEIK")
ANARCI_OUT = "\n".join(
    ["# ANARCI numbered", "# Domain 1 of query"]
    + [f"H {n:<4d}  {aa}" for n, aa in enumerate(TRASTUZUMAB_VH[:60], 1)]
    + ["H 61   -", "H 62  A  K", "//"])


# ---------------------------------------------------------------------------
# EEM charges
# ---------------------------------------------------------------------------
EEM_CASES = {
    "water": (["O", "H", "H"], [[0.0, 0.0, 0.0], [0.96, 0.0, 0.0],
                                [-0.24, 0.93, 0.0]], 0.0),
    "ammonium": (["N", "H", "H", "H", "H"],
                 [[0, 0, 0], [1, 0, 0], [-0.33, 0.94, 0],
                  [-0.33, -0.47, 0.82], [-0.33, -0.47, -0.82]], 1.0),
    "hf": (["F", "H"], [[0, 0, 0], [0.92, 0, 0]], 0.0),
    "ch": (["C", "H"], [[0, 0, 0], [1.09, 0, 0]], 0.0),
    "co2": (["O", "C", "O"], [[-1.16, 0, 0], [0, 0, 0], [1.16, 0, 0]], 0.0),
    "oh_near": (["O", "H"], [[0, 0, 0], [0.96, 0, 0]], 0.0),
    "oh_far": (["O", "H"], [[0, 0, 0], [3.0, 0, 0]], 0.0),
}


@pytest.mark.parametrize("case", sorted(EEM_CASES))
def test_eem_charges(case):
    """tests/test_charges_eem.py's molecules, charges within 1e-12."""
    els, x, q = EEM_CASES[case]
    ref = JE.eem_charges(els, np.asarray(x, float), total_charge=q)
    got = TE.eem_charges(els, np.asarray(x, float), total_charge=q)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CHARGE_TOL)
    assert abs(got.sum() - q) < 1e-10


def test_assign_eem_charges_on_a_molecule():
    """assign_eem_charges on ethanol from each package's SMILES parser and
    embedding: the same charges, and the molecule left as it was."""
    from molchanica_tpu.molecules.embed import embed_3d as j_embed
    from molchanica_tpu_torch.molecules.embed import embed_3d as t_embed
    jm, tm = j_from_smiles("CCO"), t_from_smiles("CCO")
    j_embed(jm, seed=0)
    t_embed(tm, seed=0)
    assert jm.elements == tm.elements
    np.testing.assert_allclose(tm.positions, jm.positions, rtol=0,
                               atol=1e-10)
    before = None if tm.charges is None else np.array(tm.charges)
    ref = JE.assign_eem_charges(jm)
    got = TE.assign_eem_charges(tm)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CHARGE_TOL)
    assert abs(got.sum()) < 1e-10
    if before is None:
        assert tm.charges is None
    else:
        assert np.array_equal(tm.charges, before)


# ---------------------------------------------------------------------------
# BCC charges
# ---------------------------------------------------------------------------
def test_bcc_table_equal():
    from molchanica_tpu.ff.data.bcc_table import BCC_TABLE
    assert TBT.BCC_TABLE == BCC_TABLE
    assert TB.AMBER_TO_BCC == JB.AMBER_TO_BCC


@pytest.mark.parametrize("builder", [_methanol, _acetamide, _benzene])
def test_bcc_small_molecules(builder):
    """tests/test_charges_bcc.py's molecules: types equal, charges within
    1e-12 with their net charge kept."""
    els, bonds, orders = builder()
    assert TB.bcc_atom_types(els, bonds, orders) == \
        JB.bcc_atom_types(els, bonds, orders)
    ref = JB.bcc_charges(els, bonds, bond_orders=orders)
    got = TB.bcc_charges(els, bonds, bond_orders=orders)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CHARGE_TOL)
    assert abs(got.sum()) < 1e-12


def test_bcc_on_residue_templates():
    """The 20 residue templates (scripts/fit_bcc.py's residue systems):
    graph types, apply_bcc on the Gasteiger base and bcc_charges equal."""
    from molchanica_tpu_torch.ff.charges import gasteiger_charges
    assert sorted(T_TEMPLATES) == sorted(J_TEMPLATES)
    assert len(T_TEMPLATES) == 20
    for name in sorted(T_TEMPLATES):
        els, types, bonds, orders, fc, _ = residue_system(name)
        tt = TB.bcc_atom_types(els, bonds, bond_orders=orders,
                               formal_charges=fc)
        assert tt == JB.bcc_atom_types(els, bonds, bond_orders=orders,
                                       formal_charges=fc), name
        base = gasteiger_charges(els, bonds, bond_orders=orders,
                                 formal_charges=fc)
        bt = [TB.AMBER_TO_BCC[t] for t in types]
        ref = JB.apply_bcc(base, bt, bonds)
        got = TB.apply_bcc(base, bt, bonds)
        np.testing.assert_allclose(got, ref, rtol=0, atol=CHARGE_TOL)
        ref = JB.bcc_charges(els, bonds, bond_orders=orders,
                             formal_charges=fc)
        got = TB.bcc_charges(els, bonds, bond_orders=orders,
                             formal_charges=fc)
        np.testing.assert_allclose(got, ref, rtol=0, atol=CHARGE_TOL)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------
def _sel_mol(common):
    m = common.MoleculeCommon(
        elements=["N", "C", "C", "O", "H", "N", "C", "C", "O", "O"],
        positions=np.array([[float(i), 0.0, 0.0] for i in range(10)]))
    m.atom_names = ["N", "CA", "C", "O", "H", "N", "CA", "C", "O", "OXT"]
    m.res_names = ["ALA"] * 5 + ["GLY"] * 5
    m.res_ids = [1] * 5 + [2] * 5
    m.chains = ["A"] * 5 + ["B"] * 5
    m.hetero = [False] * 9 + [True]
    return m


SELECTIONS = [
    "resn ALA", "resn GLY+ALA", "resi 2", "elem O", "name CA", "chain B",
    "hydro", "hetatm", "index 0-2+7", "resn ALA and elem C",
    "resn ALA elem C", "name CA or name OXT", "not chain A",
    "(resn ALA or resn GLY) and elem N", "polymer and not hydro",
    "within 1.5 of index 0", "byres name OXT",
    "byres (within 0.5 of index 3)", "all", "none"]
BAD_SELECTIONS = ["resn", "frobnicate X", "(resn ALA"]


@pytest.mark.parametrize("expr", SELECTIONS)
def test_selection_expressions(expr):
    """Every expression of tests/test_selection.py: equal index lists and
    masks."""
    jm, tm = _sel_mol(JCommon), _sel_mol(TCommon)
    ref = JSel.select_indices(jm, expr)
    assert TSel.select_indices(tm, expr) == ref
    assert np.array_equal(TSel.select(tm, expr), JSel.select(jm, expr))


@pytest.mark.parametrize("expr", BAD_SELECTIONS)
def test_selection_errors(expr):
    """The same SelectionError, with the same message."""
    with pytest.raises(JSel.SelectionError) as je:
        JSel.select(_sel_mol(JCommon), expr)
    with pytest.raises(TSel.SelectionError) as te:
        TSel.select(_sel_mol(TCommon), expr)
    assert str(te.value) == str(je.value)
    assert issubclass(TSel.SelectionError, ValueError)


@pytest.fixture(scope="module")
def prepared_12mer(tmp_path_factory):
    """The 12-mer through each package's builder, mmCIF round trip and
    prepare_peptide: (the heavy-atom molecule read back, with its names,
    residues and chains; the prepared all-atom spec)."""
    d = tmp_path_factory.mktemp("sel")
    out = []
    for build, write, read, prep in (
            (j_build, j_write_mmcif, j_read_mmcif, j_prepare),
            (t_build, t_write_mmcif, t_read_mmcif, t_prepare)):
        path = str(d / f"{len(out)}.cif")
        write(build(SEQ), path)
        mol = read(path)
        out.append((mol, prep(mol)))
    return out


def _spec_mol(common, spec):
    """The prepared spec as a molecule: its positions, elements by mass."""
    by_mass = {1: "H", 12: "C", 14: "N", 16: "O", 32: "S"}
    return common.MoleculeCommon(
        elements=[by_mass[int(round(m))] for m in spec.masses],
        positions=np.asarray(spec.positions))


@pytest.mark.parametrize("expr", [
    "within 4.0 of resi 3", "byres (within 3.5 of name CA and resi 6)",
    "byres (resn PRO and name CG)",
    "resn TRP and not within 2.0 of name CA",
    "chain A and resi 1-4+10 and not elem O", "byres (name OH)"])
def test_selection_on_the_12mer_read_back(prepared_12mer, expr):
    """within and byres on the 12-mer read back from mmCIF: equal index
    lists, none empty."""
    (jm, _), (tm, _) = prepared_12mer
    ref = JSel.select_indices(jm, expr)
    assert TSel.select_indices(tm, expr) == ref and ref


@pytest.mark.parametrize("expr", [
    "within 3.0 of index 0", "hydro and within 2.5 of elem N",
    "not hydro and within 5.0 of index 40-45", "elem S or elem N",
    "within 1.2 of (elem O and index 100-140)"])
def test_selection_on_the_prepared_12mer(prepared_12mer, expr):
    """within on the prepared all-atom 12-mer (hydrogens placed):
    equal index lists, none empty."""
    (_, js), (_, ts) = prepared_12mer
    ref = JSel.select_indices(_spec_mol(JCommon, js), expr)
    assert TSel.select_indices(_spec_mol(TCommon, ts), expr) == ref and ref


# ---------------------------------------------------------------------------
# Sonification
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("include_h", [True, False])
def test_sonification(include_h, tmp_path):
    """Ethanol's bond tones equal field for field, the waveform within
    1e-12 and the WAV file's bytes equal."""
    jm, tm = j_from_smiles("CCO"), t_from_smiles("CCO")
    ref = JSon.bond_tones(jm, include_h=include_h)
    got = TSon.bond_tones(tm, include_h=include_h)
    assert [dataclasses.astuple(t) for t in got] == \
        [dataclasses.astuple(t) for t in ref]
    wj = JSon.synthesize(jm, duration_s=0.2, include_h=include_h)
    wt = TSon.synthesize(tm, duration_s=0.2, include_h=include_h)
    assert wt.shape == wj.shape == (int(0.2 * 44100),)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-12)
    pj = JSon.sonify_to_file(jm, str(tmp_path / "j.wav"), 0.2, include_h)
    pt = TSon.sonify_to_file(tm, str(tmp_path / "t.wav"), 0.2, include_h)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_sonification_stiffness_override():
    """Per-bond force constants (k_by_bond) move the tones the same way."""
    jm, tm = j_from_smiles("CC=O"), t_from_smiles("CC=O")
    k = [200.0 + 50.0 * i for i in range(len(jm.bonds))]
    ref = JSon.bond_tones(jm, k_by_bond=k)
    got = TSon.bond_tones(tm, k_by_bond=k)
    assert [dataclasses.astuple(t) for t in got] == \
        [dataclasses.astuple(t) for t in ref]
    np.testing.assert_allclose(TSon.synthesize(tm, 0.05, k_by_bond=k),
                               JSon.synthesize(jm, 0.05, k_by_bond=k),
                               rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# PDBbind
# ---------------------------------------------------------------------------
INDEX_ROWS = [
    "2r58  2.00  2007   2.00  Kd=10mM       // 2r58.pdf (MLY)",
    "1a30  NMR   1998   5.00  Ki=10uM  // ref",
    "3abc  1.90  2010   7.30  IC50>50nM // x",
    "4def  2.50  2015   9.10  Kd~0.8nM // approx",
    "5ghi  1.20  2019   3.00  Ki<=1.5mM // bound",
    "6jkl  3.10  2003   6.00  EC50=1uM // other",
    "# PDB code, resolution, release year", "", "1abc 2.0 2001"]


def _aff(x):
    return None if x is None else (x[0], dataclasses.asdict(x[1]))


@pytest.mark.parametrize("row", INDEX_ROWS)
def test_pdbbind_index_rows(row):
    """Each index row parses to the same (code, Affinity), or to None."""
    ref = JP.parse_index_line(row)
    got = TP.parse_index_line(row)
    assert _aff(got) == _aff(ref)
    if ref is not None:
        a, b = got[1], ref[1]
        assert a.is_exact == b.is_exact
        assert a.is_regression_quality() == b.is_regression_quality()


def test_pdbbind_release_layout(tmp_path, monkeypatch):
    """tests/test_pdbbind.py's temporary release: the index, the entries
    and one entry by code equal; find_root reads MOLCHANICA_PDBBIND_ROOT;
    the pocket file reads into the port's MoleculePocket."""
    root = _make_release(tmp_path)
    ji, ti = JP.load_index(root), TP.load_index(root)
    assert {k: dataclasses.asdict(v) for k, v in ti.items()} == \
        {k: dataclasses.asdict(v) for k, v in ji.items()}
    for subset in ("refined", "general", "any"):
        je = JP.load_entries(root=root, subset=subset)
        te = TP.load_entries(root=root, subset=subset)
        assert [dataclasses.asdict(e) for e in te] == \
            [dataclasses.asdict(e) for e in je]
    for code in ("2XYZ", "1abc", "zzzz"):
        a, b = TP.load_entry(code, root=root), JP.load_entry(code, root=root)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.structure_for_pocket_work == b.structure_for_pocket_work
    monkeypatch.setenv("MOLCHANICA_PDBBIND_ROOT", str(root))
    assert TP.find_root() == JP.find_root() == root
    assert TP.load_entries() == [] or \
        [e.pdb_id for e in TP.load_entries()] == \
        [e.pdb_id for e in JP.load_entries()]
    monkeypatch.delenv("MOLCHANICA_PDBBIND_ROOT")
    e = TP.load_entry("1abc", root=root)
    p = MoleculePocket.from_file(e.structure_for_pocket_work, pdb_id="1abc")
    assert p.n_atoms == 2 and p.source_pdb_id == "1abc"


# ---------------------------------------------------------------------------
# Antibody
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [TRASTUZUMAB_VH, TRASTUZUMAB_VL])
def test_antibody_heuristic(seq):
    """The heuristic CDR windows (ANARCI not installed) and the liability
    flags equal."""
    ref = JA.annotate_cdrs(seq, prefer_external=False)
    got = TA.annotate_cdrs(seq, prefer_external=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.loops(seq) == ref.loops(seq)
    assert TA.humanness_flags(seq) == JA.humanness_flags(seq)


def test_antibody_rejects_non_ig():
    for mod in (JA, TA):
        with pytest.raises(ValueError):
            mod.annotate_cdrs("AAAAAAAAAA")


def test_parse_anarci():
    """_parse_anarci on a fixed numbered table, and annotate_cdrs through a
    mocked ANARCI run (probe and run_tool patched in each package)."""
    ref = JA._parse_anarci(ANARCI_OUT, TRASTUZUMAB_VH)
    got = TA._parse_anarci(ANARCI_OUT, TRASTUZUMAB_VH)
    assert ref.source == "anarci"
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert TA._parse_anarci("no table", "AAA") is None
    anns = []
    for mod in (JA, TA):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "probe",
                       lambda name: SimpleNamespace(available=True))
            mp.setattr(mod, "run_tool", lambda name, args, **kw:
                       SimpleNamespace(stdout=ANARCI_OUT, returncode=0))
            anns.append(dataclasses.asdict(mod.annotate_cdrs(
                TRASTUZUMAB_VH)))
    assert anns[1] == anns[0] and anns[0]["source"] == "anarci"
