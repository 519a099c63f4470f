"""Port parity: the molecule databases without pandas
(molchanica_tpu_torch.mol_db and its committed .npz tables) against
molchanica_tpu.mol_db's pandas DataFrames over the parquet files.

Held exactly: each .npz column against its parquet column (values and
dtype kind; read here with pandas), from_smiles' descriptors against the
JAX MolDb's, and filter_druglike, lookup_by_name, nearest (with its
distances) and query against the reference row for row.
"""
import os

import numpy as np
import pandas as pd
import pytest

from molchanica_tpu import mol_db as J
from molchanica_tpu_torch import mol_db as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMILES = ["CCO", "CC(=O)Oc1ccccc1C(=O)O", "c1ccccc1",
          "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
          "OCC1OC(O)C(O)C(O)C1O", "CN1CCC[C@H]1c2cccnc2", "NCC(=O)O",
          "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "CCN(CC)CC", "O=C(O)CCC(=O)O"]
NAMES = [f"m{i}" for i in range(len(SMILES))]
QUERIES = [
    "mol_weight < 200",
    "clogp > 0 and hbd <= 2",
    "mol_weight > 100 & tpsa < 60 | n_rings == 2",
    "not (hba > 4)",
    "~(hba > 4) & hbd < 3",
    "1 < clogp <= 3",
    "n_heavy * 2 + 1 > 25",
    "mol_weight / n_heavy > 14.5",
    "name in ['glucose', 'caffeine', 'urea']",
    "name not in ['glucose']",
    "n_rotatable % 2 == 1 or n_rings // 2 >= 1",
    "-clogp > 1",
    "clogp ** 2 < 1",
    "name == 'glycine' or smiles == 'NC(N)=O'",
    "hbd != hba",
]
BAD = ["name.str.lower() == 'x'", "__import__('os')", "lambda x: 1",
       "foo > 1", "mol_weight", "clogp is None", "smiles[0] == 'C'",
       "mol_weight > @limit"]


def _parquet(name):
    return pd.read_parquet(os.path.join(ROOT, "molchanica_tpu", "data",
                                        f"{name}.parquet"))


def _same_rows(df, db, cols=None):
    df = df.reset_index(drop=True)
    assert len(df) == len(db)
    for c in cols or df.columns:
        a, b = df[c].to_numpy(), db[c]
        if a.dtype.kind in "fi":
            np.testing.assert_array_equal(b, a, err_msg=c)
        else:
            assert list(b) == [str(v) for v in a], c


@pytest.fixture(scope="module")
def dbs():
    return T.load_embedded_dbs()


@pytest.mark.parametrize("name", T.EMBEDDED_DBS)
def test_npz_equals_parquet(name, dbs):
    df, db = _parquet(name), dbs[name]
    assert db.column_names == list(df.columns)
    for c in df.columns:
        a = df[c].to_numpy()
        if a.dtype.kind in "fi":
            assert db[c].dtype == a.dtype, c
            assert db[c].tobytes() == a.tobytes(), c
        else:
            assert db[c].dtype.kind == "U", c
            assert list(db[c]) == list(a), c
    with np.load(os.path.join(T._DATA_DIR, f"{name}.npz"),
                 allow_pickle=False) as z:
        assert list(z.files) == list(df.columns)


def test_from_smiles_descriptors():
    ref = J.MolDb.from_smiles(SMILES, names=NAMES).df
    got = T.MolDb.from_smiles(SMILES, names=NAMES)
    assert got.column_names == list(ref.columns)
    _same_rows(ref, got)


@pytest.mark.parametrize("name", T.EMBEDDED_DBS)
def test_filter_druglike(name, dbs):
    ref = J.MolDb(_parquet(name)).filter_druglike().df
    _same_rows(ref, dbs[name].filter_druglike())
    _same_rows(J.MolDb(_parquet(name)).filter_druglike(300, 1.0, 3, 6).df,
               dbs[name].filter_druglike(300, 1.0, 3, 6))


def test_embedded_counts(dbs):
    """The counts chip_smoke.py's phase Y holds on the card machine."""
    assert set(dbs) == set(T.EMBEDDED_DBS)
    assert {k: len(v) for k, v in dbs.items()} == {
        "metabolites_hmdb_core": 91, "compounds_chebi_core": 41}
    assert {k: len(v.filter_druglike()) for k, v in dbs.items()} == {
        "metabolites_hmdb_core": 81, "compounds_chebi_core": 40}


@pytest.mark.parametrize("query", ["glucose", "Aspirin", "L-ALANINE",
                                   "trimethylamine N-oxide", "nothing"])
def test_lookup_by_name(query, dbs):
    jd = {k: J.MolDb(_parquet(k)) for k in J.EMBEDDED_DBS}
    ref, got = J.lookup_by_name(query, jd), T.lookup_by_name(query, dbs)
    if ref is None:
        assert got is None
        return
    assert got[0] == ref[0]
    row = got[1]
    for c in ref[1].index:
        assert row[c] == ref[1][c] and getattr(row, c) == ref[1][c], c
    assert T.lookup_by_name(query) is not None


@pytest.mark.parametrize("smiles", ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1"])
def test_nearest(smiles, dbs):
    for name in T.EMBEDDED_DBS:
        ref = J.MolDb(_parquet(name)).nearest(smiles, k=7)
        got = dbs[name].nearest(smiles, k=7)
        assert got.column_names[-1] == "distance"
        _same_rows(ref, got)


@pytest.mark.parametrize("expr", QUERIES)
def test_query_matches_dataframe(expr, dbs):
    name = "metabolites_hmdb_core"
    ref = _parquet(name).query(expr)
    assert 0 < len(ref) < 91, expr          # each query selects
    _same_rows(ref, dbs[name].query(expr))


@pytest.mark.parametrize("expr", BAD)
def test_query_outside_the_grammar_raises(expr, dbs):
    with pytest.raises(ValueError):
        dbs["metabolites_hmdb_core"].query(expr)


def test_open_save_roundtrip(tmp_path, dbs):
    db = dbs["compounds_chebi_core"]
    path = str(tmp_path / "c.npz")
    assert db.save(path) == path
    back = T.MolDb.open(path)
    assert back.column_names == db.column_names
    for c in db.column_names:
        assert back[c].dtype == db[c].dtype
        np.testing.assert_array_equal(back[c], db[c])
    with pytest.raises(ValueError, match="convert_embedded_dbs"):
        T.MolDb.open(os.path.join(ROOT, "molchanica_tpu", "data",
                                  "compounds_chebi_core.parquet"))
    with pytest.raises(ValueError):
        db.save(str(tmp_path / "c.parquet"))
    mols = list(db.molecules(limit=3))
    assert [m.n_atoms for m in mols] == [
        m.n_atoms for m in J.MolDb(_parquet("compounds_chebi_core"))
        .molecules(limit=3)]
