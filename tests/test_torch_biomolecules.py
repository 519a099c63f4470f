"""Port parity of the biomolecule builders (molchanica_tpu_torch.ff.data.
protein_ff14sb, .molecules.geometry, .peptide_builder, .peptide,
.nucleic_acid, .lipid, .crystal_lattice, .editor, .structure_prediction
and .external) against molchanica_tpu's, on the CPU.

The builders are numpy copies, so the tolerances are tight: the force
field and the templates equal key for key, geometry within 1e-12,
positions within 1e-10, every MolSpec field equal with charges within
1e-12. The slice as a whole (sequence -> baseline structure -> mmCIF ->
prepare_peptide -> assemble_system -> compute_energy_snapshot) is held
per term in float64 within 1e-9 relative, and the solvated 6-mer's
build_dynamics assembles the reference's system. No JAX MdSim runs a
trajectory here: the editor's live MD runs on the port alone, at
tests/test_editor.py's contract. The external structure predictors are
mocked in each package's registry; none is run.
"""
import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu import structure_prediction as JSP
from molchanica_tpu import external_tools as JTools
from molchanica_tpu.ff.data import protein_ff14sb as JFF
from molchanica_tpu.io.mmcif import read_mmcif as j_read_mmcif
from molchanica_tpu.io.mmcif import write_mmcif as j_write_mmcif
from molchanica_tpu.io.pdb import write_pdb as j_write_pdb
from molchanica_tpu.md import config as JC
from molchanica_tpu.md import dynamics as JD
from molchanica_tpu.md.engine import compute_energy_snapshot as j_snapshot
from molchanica_tpu.md.engine import select_method as j_select_method
from molchanica_tpu.molecules import common as JCommon
from molchanica_tpu.molecules import crystal_lattice as JX
from molchanica_tpu.molecules import geometry as JG
from molchanica_tpu.molecules import lipid as JL
from molchanica_tpu.molecules import nucleic_acid as JNA
from molchanica_tpu.molecules import peptide as JPep
from molchanica_tpu.molecules import peptide_builder as JPB
from molchanica_tpu.molecules.editor import MolEditor as JEditor
from molchanica_tpu.molecules.spec import assemble_system as j_assemble
from molchanica_tpu_torch import external as TExternal
from molchanica_tpu_torch import external_tools as TTools
from molchanica_tpu_torch import structure_prediction as TSP
from molchanica_tpu_torch.ff.data import protein_ff14sb as TFF
from molchanica_tpu_torch.io.mmcif import read_mmcif as t_read_mmcif
from molchanica_tpu_torch.io.mmcif import write_mmcif as t_write_mmcif
from molchanica_tpu_torch.io.pdb import write_pdb as t_write_pdb
from molchanica_tpu_torch.md import config as TC
from molchanica_tpu_torch.md import dynamics as TD
from molchanica_tpu_torch.md.engine import compute_energy_snapshot
from molchanica_tpu_torch.md.engine import select_method
from molchanica_tpu_torch.molecules import common as TCommon
from molchanica_tpu_torch.molecules import crystal_lattice as TX
from molchanica_tpu_torch.molecules import geometry as TG
from molchanica_tpu_torch.molecules import lipid as TL
from molchanica_tpu_torch.molecules import nucleic_acid as TNA
from molchanica_tpu_torch.molecules import peptide as TPep
from molchanica_tpu_torch.molecules import peptide_builder as TPB
from molchanica_tpu_torch.molecules.editor import MolEditor
from molchanica_tpu_torch.molecules.spec import assemble_system
from molchanica_tpu_torch.molecules.spec_json import spec_to_dict
from test_torch_user_layer import _assembled_equal, _no_engine

torch.set_num_threads(1)

SEQ12 = "ASGVLFKWPHTY"          # tests/test_peptide.py: every chemistry
HP35 = "LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF"   # villin headpiece HP35
ALL20 = "ACDEFGHIKLMNPQRSTVWY"
POS_TOL = 1e-10
CHARGE_TOL = 1e-12
ENERGY_REL = 1e-9


def _mol_equal(a, b, tol=POS_TOL):
    """Two MoleculeCommon: every list field equal, positions within tol."""
    for f in ("elements", "atom_names", "res_names", "res_ids", "chains",
              "hetero"):
        assert list(getattr(a, f) or []) == list(getattr(b, f) or []), f
    assert sorted(map(tuple, a.bonds)) == sorted(map(tuple, b.bonds))
    np.testing.assert_allclose(np.asarray(a.positions),
                               np.asarray(b.positions), rtol=0, atol=tol)
    if a.charges is None or b.charges is None:
        assert a.charges is None and b.charges is None
    else:
        np.testing.assert_allclose(np.asarray(a.charges),
                                   np.asarray(b.charges), rtol=0,
                                   atol=CHARGE_TOL)


def _spec_equal(a, b):
    """Two MolSpecs field for field: charges within 1e-12, the rest
    equal."""
    da, db = spec_to_dict(a), spec_to_dict(b)
    assert set(da) == set(db)
    np.testing.assert_allclose(da.pop("charges"), db.pop("charges"),
                               rtol=0, atol=CHARGE_TOL)
    for k in da:
        assert da[k] == db[k], k
    assert type(a).__name__ == type(b).__name__ == "MolSpec"


# ---------------------------------------------------------------------------
# The force field and the templates
# ---------------------------------------------------------------------------
def _plain(v):
    """Dataclass terms (DihedralTerm) as tuples, recursively."""
    if dataclasses.is_dataclass(v):
        return ("dc", type(v).__name__, dataclasses.astuple(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def test_protein_ff_equal():
    """PROTEIN_FF key for key: masses, bonds, angles, dihedrals and
    impropers (as DihedralTerm tuples), nonbonded, equivalences, title."""
    for f in dataclasses.fields(JFF.PROTEIN_FF):
        a = getattr(TFF.PROTEIN_FF, f.name)
        b = getattr(JFF.PROTEIN_FF, f.name)
        if isinstance(b, dict):
            assert list(a) == list(b), f.name
        assert _plain(a) == _plain(b), f.name
    assert type(TFF.PROTEIN_FF).__module__.startswith("molchanica_tpu_torch")
    assert len(TFF.PROTEIN_FF.dihedrals) > 0 and "P" not in \
        TFF.PROTEIN_FF.nonbonded


def test_residue_templates_aliases_patches_equal():
    assert list(TFF.RESIDUE_TEMPLATES) == list(JFF.RESIDUE_TEMPLATES)
    for name, tpl in JFF.RESIDUE_TEMPLATES.items():
        assert TFF.RESIDUE_TEMPLATES[name] == tpl, name
    assert len(TFF.RESIDUE_TEMPLATES) == 20
    assert TFF.RESIDUE_ALIASES == JFF.RESIDUE_ALIASES
    assert TFF.RESIDUE_ALIASES["HIE"] == "HIS"
    assert TFF.NTERM_PATCH == JFF.NTERM_PATCH
    assert TFF.CTERM_PATCH == JFF.CTERM_PATCH


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,k", [("tetra", k) for k in range(5)]
                         + [("planar", k) for k in (1, 2, 3)])
def test_geometry(kind, k):
    """find_tetra_posits (0 to 4 known substituents) and
    find_planar_posits (1 to 3) on seeded centers and substituents, within
    1e-12."""
    rng = np.random.default_rng(10 * k + (kind == "planar"))
    for _ in range(5):
        center = rng.normal(size=3) * 3.0
        known = center + rng.normal(size=(k, 3))
        blen = float(rng.uniform(0.9, 1.6))
        jf = getattr(JG, f"find_{kind}_posits")
        tf = getattr(TG, f"find_{kind}_posits")
        ref = np.asarray(jf(center, known, blen))
        got = np.asarray(tf(center, known, blen))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        if len(got):
            np.testing.assert_allclose(np.linalg.norm(got - center, axis=1),
                                       blen, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# The peptide builder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("angles", ["default", "scalar", "per_residue"])
def test_build_peptide(angles):
    """The 20 amino acids with the default, scalar and per-residue
    phi/psi: names and bonds equal, positions within 1e-10."""
    if angles == "default":
        kw = {}
    elif angles == "scalar":
        kw = dict(phi=-57.0, psi=-47.0)
    else:
        rng = np.random.default_rng(5)
        kw = dict(phi=rng.uniform(-180, 0, len(ALL20)),
                  psi=rng.uniform(-60, 180, len(ALL20)))
    ref = JPB.build_peptide(ALL20, **kw)
    got = TPB.build_peptide(ALL20, **kw)
    _mol_equal(got, ref)
    assert len(set(got.res_names)) == 20 and got.n_atoms > 150
    assert type(got).__module__ == TCommon.__name__


# ---------------------------------------------------------------------------
# prepare_peptide
# ---------------------------------------------------------------------------
def _prepare_case(case, tmp_path):
    """(reference spec, port spec) of one route to prepare_peptide."""
    out = []
    for n, (SP, PB, Pep, w_cif, r_cif, w_pdb) in enumerate((
            (JSP, JPB, JPep, j_write_mmcif, j_read_mmcif, j_write_pdb),
            (TSP, TPB, TPep, t_write_mmcif, t_read_mmcif, t_write_pdb))):
        if case == "mmcif_12mer":
            path = str(tmp_path / f"{n}.cif")
            w_cif(PB.build_peptide(SEQ12), path)
            spec = Pep.prepare_peptide(r_cif(path))
        elif case == "mmcif_file_12mer":
            path = str(tmp_path / f"{n}.cif")
            w_cif(PB.build_peptide(SEQ12), path)
            spec = Pep.prepare_peptide_mmcif(path)
        elif case == "hp35_baseline":
            path = str(tmp_path / f"{n}.cif")
            w_cif(SP.predict_structure(HP35, model="baseline"), path)
            spec = Pep.prepare_peptide(r_cif(path))
        elif case == "neutral_termini":
            spec = Pep.prepare_peptide(PB.build_peptide(SEQ12),
                                       neutral_termini=True)
        elif case == "pdb":
            path = str(tmp_path / f"{n}.pdb")
            w_pdb(PB.build_peptide("MCHDER"), path)
            spec = Pep.prepare_peptide_pdb(path)
        elif case == "populate_hydrogens":
            spec = Pep.populate_hydrogens(PB.build_peptide("GCW"))
        out.append(spec)
    return out


@pytest.mark.parametrize("case", ["mmcif_12mer", "mmcif_file_12mer",
                                  "hp35_baseline", "neutral_termini", "pdb",
                                  "populate_hydrogens"])
def test_prepare_peptide(case, tmp_path):
    """Each route to prepare_peptide (the 12-mer after the mmCIF round
    trip, HP35 from the baseline predictor, neutral termini, the PDB
    route, populate_hydrogens): every MolSpec field equal, charges within
    1e-12, the net charge an integer."""
    ref, got = _prepare_case(case, tmp_path)
    _spec_equal(got, ref)
    assert got.ff_mol_type == "peptide"
    q = float(np.sum(got.charges))
    assert abs(q - round(q)) < 1e-9
    if case == "hp35_baseline":
        assert got.n_atoms == 579 and round(q) == 2


def test_prepare_peptide_his_alias(tmp_path):
    """A HIE residue read from a file takes the HIS template (alias) in
    both packages."""
    out = []
    for PB, Pep, w, r in ((JPB, JPep, j_write_mmcif, j_read_mmcif),
                          (TPB, TPep, t_write_mmcif, t_read_mmcif)):
        mol = PB.build_peptide("AHA")
        mol.res_names = ["HIE" if x == "HIS" else x for x in mol.res_names]
        path = str(tmp_path / f"{len(out)}.cif")
        w(mol, path)
        out.append(Pep.prepare_peptide(r(path)))
    _spec_equal(out[1], out[0])


def test_filter_drops_hetero():
    """tests/test_peptide.py's hetero filter: a water appended to a
    dipeptide is dropped, the same atoms kept."""
    outs = []
    for PB, Pep, C in ((JPB, JPep, JCommon), (TPB, TPep, TCommon)):
        mol = PB.build_peptide("AG")
        mol2 = C.MoleculeCommon(
            elements=mol.elements + ["O"],
            positions=np.concatenate([mol.positions, [[50.0, 50, 50]]]),
            atom_names=mol.atom_names + ["O"],
            res_names=mol.res_names + ["HOH"],
            res_ids=mol.res_ids + [99], chains=mol.chains + ["A"],
            hetero=mol.hetero + [True])
        f = Pep.filter_peptide_atoms(mol2)
        assert f.n_atoms == mol.n_atoms
        outs.append(f)
    _mol_equal(outs[1], outs[0], tol=0.0)


def test_prepare_rejects_nonpeptide():
    """A lone hetero ligand raises PeptideError, with the same message."""
    msgs = []
    for Pep, C in ((JPep, JCommon), (TPep, TCommon)):
        m = C.MoleculeCommon(elements=["C"], positions=np.zeros((1, 3)),
                             res_names=["LIG"], res_ids=[1], chains=["A"],
                             atom_names=["C1"], hetero=[True])
        with pytest.raises(Pep.PeptideError) as e:
            Pep.prepare_peptide(m)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert TPep.PeptideError is not JPep.PeptideError


# ---------------------------------------------------------------------------
# Structure prediction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", ["AEAEAEAEAEAEAEAE", "VIVIVIVIVIVIVIVI",
                                 "GPGGPGGPGGPG", HP35, SEQ12])
def test_secondary_structure(seq):
    assert TSP.assign_secondary_structure(seq) == \
        JSP.assign_secondary_structure(seq)
    for w in (3, 7):
        assert TSP.assign_secondary_structure(seq, window=w) == \
            JSP.assign_secondary_structure(seq, window=w)


@pytest.mark.parametrize("seq", ["AEAEAEAEAEAE", HP35])
def test_predict_structure_baseline(seq):
    """The baseline fold: the same molecule (positions within 1e-10) and
    metadata; 'auto' falls back to it when no tool is installed."""
    ref = JSP.predict_structure(seq, model="baseline")
    got = TSP.predict_structure(seq, model="baseline")
    _mol_equal(got, ref)
    assert got.metadata == ref.metadata
    assert got.metadata["predictor"] == "baseline"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTools, "probe",
                   lambda name: SimpleNamespace(available=False))
        assert TSP.available_models() == ["baseline"]
        _mol_equal(TSP.predict_structure(seq), ref)


def _fake_tool(write_pdb, build, calls):
    """Stands in for run_tool: records the call and writes the built
    peptide where the model would write its structure."""
    def run_tool(name, args, cwd=None, timeout=600, **kw):
        calls.append((name, [a.replace(cwd, "<wd>") for a in args],
                      timeout))
        mol = build("AEAEAE")
        write_pdb(mol, os.path.join(cwd, "out", "model_0.pdb"))
        if name == "boltz2":
            with open(os.path.join(cwd, "out", "affinity_B.json"), "w") as fh:
                fh.write('{"affinity_pred_value": -1.5}')
        return SimpleNamespace(returncode=0, stdout="", stderr="")
    return run_tool


@pytest.mark.parametrize("model", ["esmfold", "opendde", "boltz2"])
def test_predict_structure_dispatch_mocked(model):
    """tests/test_structure_prediction.py's dispatch with each external
    model mocked in each package's registry: the same command line, the
    same structure read back, the same affinity; the unknown model and an
    uninstalled one raise in both."""
    got = []
    for SP, Tools, PB, wp in ((JSP, JTools, JPB, j_write_pdb),
                              (TSP, TTools, TPB, t_write_pdb)):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Tools, "probe",
                       lambda name: SimpleNamespace(available=True))
            mp.setattr(Tools, "require", lambda name: "/bin/" + name)
            mp.setattr(Tools, "run_tool", _fake_tool(
                lambda m, p: (os.makedirs(os.path.dirname(p), exist_ok=True),
                              wp(m, p)), PB.build_peptide, calls))
            assert SP.available_models() == ["boltz2", "opendde", "esmfold",
                                             "baseline"]
            mol = SP.predict_structure("AEAEAE", model=model, timeout=77)
            aff = None
            if model == "boltz2":
                mol, aff = SP.predict_boltz2(
                    "AEAEAE", SP.BoltzOptions(ligand_smiles="CCO",
                                              affinity_binder=True))
        got.append((mol, calls, aff))
    (jm, jcalls, jaff), (tm, tcalls, taff) = got
    _mol_equal(tm, jm)
    assert tcalls == jcalls and tcalls[0][0] == model
    assert taff == jaff
    for SP in (JSP, TSP):
        with pytest.raises(ValueError):
            SP.predict_structure("AAA", model="alphafold99")
        if not SP.tools.probe("boltz2").available:
            with pytest.raises(Exception) as e:
                SP.predict_structure("AAA", model="boltz2")
            assert "boltz" in str(e.value).lower()


def test_external_shim():
    """molchanica_tpu_torch.external re-exports the port's drivers."""
    assert TExternal.predict_structure is TSP.predict_structure
    assert TExternal.MODELS == JSP.MODELS
    assert TExternal.BoltzOptions is TSP.BoltzOptions
    assert TExternal.available_models is TSP.available_models
    assert TExternal.predict_boltz2 is TSP.predict_boltz2


# ---------------------------------------------------------------------------
# Nucleic acids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,kind,double", [
    ("GATTACA", "dna", True), ("AUGGCU", "rna", False),
    ("GCGC", "dna", True), ("ACGU", "rna", True)])
def test_nucleic_acid(seq, kind, double):
    """MoleculeNucleicAcid.from_seq: the duplex and the RNA strand, every
    field equal, positions within 1e-10."""
    ref = JNA.MoleculeNucleicAcid.from_seq(seq, kind=kind, double=double)
    got = TNA.MoleculeNucleicAcid.from_seq(seq, kind=kind, double=double)
    assert (got.kind, got.seq, got.double_stranded) == \
        (ref.kind, ref.seq, ref.double_stranded)
    _mol_equal(got.common, ref.common)
    assert got.common.name == ref.common.name


def test_build_strand():
    ref = JNA.build_strand("GATC", "dna", phase0=0.3, chain="C")
    got = TNA.build_strand("GATC", "dna", phase0=0.3, chain="C")
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(b, np.ndarray) or (isinstance(b, list) and b and
                                         isinstance(b[0], np.ndarray)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=POS_TOL)
        else:
            assert a == b


def test_nucleic_to_spec_and_dna_before_protein(tmp_path):
    """to_spec("GAT" duplex): the same MolSpec, net charge -4 (2 P per
    strand). The port builds DNA first, then a protein: its PROTEIN_FF
    stays the reference's (to_spec extends a copy with P), and the protein
    prepared after it equals the reference's."""
    ref = JNA.MoleculeNucleicAcid.from_seq("GAT", double=True).to_spec()
    got = TNA.MoleculeNucleicAcid.from_seq("GAT", double=True).to_spec()
    _spec_equal(got, ref)
    np.testing.assert_allclose(float(np.sum(got.charges)), -4.0, atol=1e-6)
    assert got.ff_mol_type == "dna"
    assert "P" not in TFF.PROTEIN_FF.nonbonded
    assert "P" not in TFF.PROTEIN_FF.masses
    test_protein_ff_equal()
    refp, gotp = _prepare_case("mmcif_12mer", tmp_path)
    _spec_equal(gotp, refp)


# ---------------------------------------------------------------------------
# Lipids and the membrane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tail,seed", [(14, 0), (8, 3)])
def test_build_pc_lipid(tail, seed):
    """build_pc_lipid bit for bit (the rng stays numpy's on the host)."""
    ref = JL.build_pc_lipid(tail, seed)
    got = TL.build_pc_lipid(tail, seed)
    da, db = spec_to_dict(got), spec_to_dict(ref)
    assert da == db
    assert np.array_equal(got.positions, ref.positions)
    assert abs(float(np.sum(got.charges))) < 1e-10


@pytest.mark.parametrize("args", [(3, 3), (2, 2, 64.0, 8, 1)])
def test_make_membrane(args):
    """make_membrane bit for bit: every lipid's spec and the box."""
    jm, jb = JL.make_membrane(*args)
    tm, tb = TL.make_membrane(*args)
    assert np.array_equal(tb, jb) and len(tm) == len(jm)
    for a, b in zip(tm, jm):
        assert np.array_equal(a.positions, b.positions)
        assert spec_to_dict(a) == spec_to_dict(b)
    assert TL.AREA_PER_LIPID_PC == JL.AREA_PER_LIPID_PC


# ---------------------------------------------------------------------------
# Crystal lattices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,reps", [
    ("graphite", (3, 3, 2)), ("graphite", (3, 3, 1)),
    ("diamond", (2, 2, 2)), ("nacl", (2, 2, 2)), ("nacl", (3, 2, 1))])
def test_crystal_lattice(name, reps):
    ref = getattr(JX, f"build_{name}")(reps=reps)
    got = getattr(TX, f"build_{name}")(reps=reps)
    _mol_equal(got, ref, tol=0.0)
    for k in ("GRAPHITE_LATTICE_A", "DIAMOND_LATTICE_A",
              "SODIUM_CHLORIDE_LATTICE_A"):
        assert getattr(TX, k) == getattr(JX, k)


# ---------------------------------------------------------------------------
# The editor
# ---------------------------------------------------------------------------
def _edits(Editor, C):
    """tests/test_editor.py's edits: methane built by hand, then the
    delete and bond edits."""
    ed = Editor()
    c = ed.add_atom("C")
    ed.add_hydrogens(c, count=4)
    ed2 = Editor(C.MoleculeCommon(
        elements=["C", "C", "O"],
        positions=np.array([[0.0, 0, 0], [1.5, 0, 0], [3.0, 0, 0]]),
        bonds=[(0, 1), (1, 2)]))
    ed2.delete_atom(1)
    ed2.add_bond(0, 1)
    ed2.add_atom("N", bond_to=1, geometry="planar")
    ed2.add_atom("H", bond_to=1)
    ed2.delete_bond(0, 1)
    ed2.add_atom("C")
    return ed.mol, ed2.mol


def test_editor_edits():
    jm, jm2 = _edits(JEditor, JCommon)
    tm, tm2 = _edits(MolEditor, TCommon)
    for a, b in ((tm, jm), (tm2, jm2)):
        assert a.elements == b.elements
        assert a.bonds == b.bonds
        np.testing.assert_allclose(np.asarray(a.positions),
                                   np.asarray(b.positions), rtol=0,
                                   atol=1e-12)
    assert tm.elements == ["C", "H", "H", "H", "H"]


def test_editor_live_md_on_the_port():
    """tests/test_editor.py's live MD on the port's MdSim (device="cpu"):
    the stretched bond relaxes by more than 0.1 A over 6 ticks, and an O
    added mid-run rebuilds the sim lazily (9 atoms, finite)."""
    ed = MolEditor(dt_ps=0.0005, steps_per_tick=5, device="cpu")
    c = ed.add_atom("C")
    c2 = ed.add_atom("C", bond_to=c)
    ed.add_hydrogens(c, count=3)
    ed.add_hydrogens(c2, count=3)
    pos = np.asarray(ed.mol.positions)
    pos[1] = pos[0] + (pos[1] - pos[0]) * 1.6
    ed.mol.positions = pos
    d0 = np.linalg.norm(ed.mol.positions[1] - ed.mol.positions[0])
    ed.md_step()                       # not started: nothing moves
    assert ed._sim is None
    ed.start()
    for _ in range(6):
        ed.md_step()
    assert ed._sim.device == torch.device("cpu")
    d1 = np.linalg.norm(
        np.asarray(ed.mol.positions)[1] - np.asarray(ed.mol.positions)[0])
    assert d1 < d0 - 0.1
    ed.add_atom("O", bond_to=1)
    assert ed._sim is None
    ed.md_step()
    assert ed.mol.n_atoms == 9
    assert np.isfinite(np.asarray(ed.mol.positions)).all()
    assert isinstance(ed.mol.positions, np.ndarray)


def test_editor_needs_cuda_unless_cpu_is_asked():
    """No fallback: MolEditor's default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ed = MolEditor()
    c = ed.add_atom("C")
    ed.add_hydrogens(c, count=4)
    ed.start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed.md_step()


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------
def _chain(SP, Pep, w_cif, r_cif, seq, path):
    """sequence -> baseline structure -> mmCIF -> prepare_peptide."""
    w_cif(SP.predict_structure(seq, model="baseline"), path)
    return Pep.prepare_peptide(r_cif(path))


def _jax_float64(jt):
    fl = {}
    for f in dataclasses.fields(jt):
        v = getattr(jt, f.name)
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
            fl[f.name] = jnp.asarray(np.asarray(v), jnp.float64)
    return jt.replace(**fl)


def test_slice_energy_per_term(tmp_path):
    """The 12-mer through the whole chain in each package, then
    assemble_system and compute_energy_snapshot in float64 in vacuum:
    every term within 1e-9 of the sum of |terms|."""
    js = _chain(JSP, JPep, j_write_mmcif, j_read_mmcif, SEQ12,
                str(tmp_path / "j.cif"))
    ts = _chain(TSP, TPep, t_write_mmcif, t_read_mmcif, SEQ12,
                str(tmp_path / "t.cif"))
    _spec_equal(ts, js)
    ja, ta = j_assemble([js]), assemble_system([ts])
    _assembled_equal(SimpleNamespace(assembled=ja),
                     SimpleNamespace(assembled=ta))
    jc = JC.MdConfig(dtype="float64")
    tc = TC.MdConfig(dtype="float64")
    ref = j_snapshot(_jax_float64(ja.topology), jc,
                     np.asarray(ja.positions, np.float64), None)
    got = compute_energy_snapshot(ta.topology, tc,
                                  np.asarray(ta.positions, np.float64),
                                  None, device="cpu")
    assert set(got) == set(ref)
    scale = sum(abs(v) for v in ref.values())
    for k, r in ref.items():
        assert abs(got[k] - r) <= ENERGY_REL * scale, (k, got[k], r)
    assert all(np.isfinite(v) for v in got.values())


def test_slice_solvated_build(tmp_path):
    """The 6-mer, prepared, in OPC at the quick start's MdConfig (pad 10
    A, relaxation off) through build_dynamics(..., device="cpu"): the
    reference's assembled system bit for bit (positions, box, every
    topology field), the same method and site count, and the port's MdSim
    built on the CPU."""
    seq = "AEAEAE"
    js = _chain(JSP, JPep, j_write_mmcif, j_read_mmcif, seq,
                str(tmp_path / "j.cif"))
    ts = _chain(TSP, TPep, t_write_mmcif, t_read_mmcif, seq,
                str(tmp_path / "t.cif"))
    jc, tc = (C.MdConfig(integrator=C.Integrator.langevin_middle(gamma=1.0),
                         temp_target=310.0, solvent=C.Solvent.water_opc(),
                         sim_box=C.SimBoxInit.pad_(10.0),
                         hydrogen_constraint=C.HydrogenConstraint.shake(),
                         dtype="float32", max_init_relaxation_iters=None)
              for C in (JC, TC))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "MdSim", _no_engine(j_select_method))
        jsim = JD.build_dynamics([JD.MolDynamics(ff_mol_type="peptide",
                                                 spec=js)], jc)
    tsim = TD.build_dynamics([TD.MolDynamics(ff_mol_type="peptide",
                                             spec=ts)], tc, device="cpu")
    _assembled_equal(jsim, tsim)
    ta = tsim.assembled
    assert tsim.method == jsim.method == select_method(
        ta.box_extent, ta.positions.shape[0], tc)
    assert ta.n_waters > 0
    assert ta.topology.n_atoms_real == jsim.assembled.topology.n_atoms_real
    x = tsim.state.positions.numpy()
    assert x.shape == ta.positions.shape and np.isfinite(x).all()
    assert tsim.device == torch.device("cpu")
