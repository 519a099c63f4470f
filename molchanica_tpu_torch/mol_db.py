"""Molecule databases: screening/property sets as tables of numpy columns.

Port of molchanica_tpu.mol_db (reference parity: the `mol_db` parquet
molecule databases, SURVEY section 2.3: bulk molecule storage with computed
descriptors). The JAX package holds a pandas DataFrame over parquet; the
port holds an ordered dict of numpy columns and stores it as .npz (one
array per column, loadable with allow_pickle=False), so it needs neither
pandas nor a parquet reader. SMILES is the canonical structure column and
descriptors come from molecules/characterization on ingest.

Departures (ROADMAP Queue 3): `nearest` returns a MolDb with a `distance`
column, not a DataFrame; `open` of a .parquet file raises and names
scripts/convert_embedded_dbs.py; `query` takes the subset of pandas'
expression grammar below, evaluated over Python's `ast` without `eval`.
"""
from __future__ import annotations

import ast
import io
import os
import tokenize
from typing import Dict, Iterable, List, Optional

import numpy as np

DESCRIPTOR_COLS = ["mol_weight", "tpsa", "clogp", "n_rings",
                   "n_aromatic_rings", "n_rotatable", "hbd", "hba",
                   "n_heavy"]
CONVERT_SCRIPT = "scripts/convert_embedded_dbs.py"


def _descriptor_row(smiles: str) -> Optional[dict]:
    from .molecules.characterization import characterize
    from .molecules.smiles import from_smiles

    try:
        mol = from_smiles(smiles)
        ch = characterize(mol)
    except Exception:
        return None
    return {
        "smiles": smiles,
        "mol_weight": ch.mol_weight, "tpsa": ch.tpsa, "clogp": ch.clogp,
        "n_rings": len(ch.rings), "n_aromatic_rings": ch.n_aromatic_rings,
        "n_rotatable": len(ch.rotatable_bonds),
        "hbd": ch.h_bond_donors, "hba": ch.h_bond_acceptors,
        "n_heavy": ch.n_heavy,
    }


class Row:
    """One row of a MolDb: `row.smiles` and `row["name"]` both work."""

    def __init__(self, values: Dict[str, object]):
        object.__setattr__(self, "_values", values)

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name):
        return self._values[name]

    def __repr__(self):
        return f"Row({self._values!r})"


class MolDb:
    """A molecule table (one row per molecule) with descriptors: an
    ordered dict of equal-length numpy columns."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        lens = {len(v) for v in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lens)}")

    @staticmethod
    def from_smiles(smiles: Iterable[str], names: Optional[List[str]] = None
                    ) -> "MolDb":
        rows = []
        for i, smi in enumerate(smiles):
            r = _descriptor_row(smi)
            if r is None:
                continue
            if names is not None:
                r["name"] = names[i]
            rows.append(r)
        keys = list(rows[0]) if rows else []
        return MolDb({k: np.asarray([r[k] for r in rows]) for k in keys})

    @staticmethod
    def open(path) -> "MolDb":
        if str(path).lower().endswith(".parquet"):
            raise ValueError(
                f"{path}: the port reads .npz tables, not parquet; convert "
                f"it as {CONVERT_SCRIPT} does")
        with np.load(path, allow_pickle=False) as z:
            return MolDb({k: z[k] for k in z.files})

    def save(self, path):
        """Write the table as .npz (one array per column) at `path`."""
        if not str(path).lower().endswith(".npz"):
            raise ValueError(f"{path}: MolDb.save writes .npz files")
        with open(path, "wb") as fh:
            np.savez(fh, **self.columns)
        return path

    def __len__(self):
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, column: str) -> np.ndarray:
        return self.columns[column]

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def row(self, i: int) -> Row:
        return Row({k: v[i].item() for k, v in self.columns.items()})

    def take(self, idx) -> "MolDb":
        """The rows at `idx` (an index array or a boolean mask), in order."""
        return MolDb({k: v[idx] for k, v in self.columns.items()})

    # ---- query surface ----
    def filter_druglike(self, max_mw: float = 500.0, max_clogp: float = 5.0,
                        max_hbd: int = 5, max_hba: int = 10) -> "MolDb":
        """Lipinski filter."""
        c = self.columns
        return self.take((c["mol_weight"] <= max_mw)
                         & (c["clogp"] <= max_clogp)
                         & (c["hbd"] <= max_hbd) & (c["hba"] <= max_hba))

    def query(self, expr: str) -> "MolDb":
        """The rows where `expr` holds, as DataFrame.query reads it: column
        names, constants, comparisons (chained too), and / or / not,
        & / | / ~ (with the precedence of and / or / not, as in pandas),
        arithmetic, and `in` / `not in` against a list. Anything else
        raises ValueError."""
        mask = _QueryEval(self.columns).run(expr)
        if not (isinstance(mask, np.ndarray) and mask.dtype == bool
                and mask.shape == (len(self),)):
            raise ValueError(f"query {expr!r} does not give one boolean "
                             "per row")
        return self.take(mask)

    def nearest(self, smiles: str, k: int = 10) -> "MolDb":
        """Descriptor-space nearest neighbours (normalized Euclidean), with
        their `distance` column."""
        probe = _descriptor_row(smiles)
        if probe is None:
            raise ValueError(f"unparseable SMILES: {smiles}")
        # column-major, as DataFrame.to_numpy gives it: the reductions
        # below then sum in the reference's order
        X = np.asfortranarray(np.stack(
            [self.columns[c].astype(float) for c in DESCRIPTOR_COLS], axis=1))
        mu, sd = X.mean(0), X.std(0) + 1e-9
        q = (np.asarray([probe[c] for c in DESCRIPTOR_COLS]) - mu) / sd
        d = np.linalg.norm((X - mu) / sd - q, axis=1)
        idx = np.argsort(d)[:k]
        out = self.take(idx)
        out.columns["distance"] = d[idx]
        return out

    def molecules(self, limit: Optional[int] = None):
        """Materialize MoleculeCommon objects (lazy by row)."""
        from .molecules.smiles import from_smiles

        for smi in self.columns["smiles"][:limit]:
            yield from_smiles(str(smi))


class _QueryEval:
    """Evaluates a query expression over numpy columns by walking its
    `ast`; never calls eval."""

    _ARITH = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
              ast.Div: np.true_divide, ast.FloorDiv: np.floor_divide,
              ast.Mod: np.mod, ast.Pow: np.power}
    _CMP = {ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less,
            ast.LtE: np.less_equal, ast.Gt: np.greater,
            ast.GtE: np.greater_equal}

    def __init__(self, columns):
        self.columns = columns

    def run(self, expr: str):
        try:
            toks = [(t.type, t.string) for t in tokenize.generate_tokens(
                io.StringIO(expr.strip()).readline)]
            # pandas reads & and | as `and` and `or` (their precedence too)
            toks = [(tokenize.NAME, {"&": "and", "|": "or"}[s])
                    if t == tokenize.OP and s in "&|" else (t, s)
                    for t, s in toks]
            tree = ast.parse(tokenize.untokenize(toks).strip(), mode="eval")
        except (SyntaxError, tokenize.TokenError) as e:
            raise ValueError(f"query {expr!r}: {e}") from None
        return self.visit(tree.body)

    def visit(self, node):
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (bool, int, float, str)):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in self.columns:
                raise ValueError(f"query: no column {node.id!r}")
            return self.columns[node.id]
        if isinstance(node, ast.BoolOp):
            vals = [np.asarray(self.visit(v)) for v in node.values]
            op = (np.logical_and if isinstance(node.op, ast.And)
                  else np.logical_or)
            out = vals[0]
            for v in vals[1:]:
                out = op(out, v)
            return out
        if isinstance(node, ast.UnaryOp):
            v = self.visit(node.operand)
            if isinstance(node.op, (ast.Not, ast.Invert)):
                v = np.asarray(v)
                return np.logical_not(v) if v.dtype == bool else np.invert(v)
            if isinstance(node.op, ast.USub):
                return np.negative(v)
            if isinstance(node.op, ast.UAdd):
                return v
        if isinstance(node, ast.BinOp) and type(node.op) in self._ARITH:
            return self._ARITH[type(node.op)](self.visit(node.left),
                                              self.visit(node.right))
        if isinstance(node, ast.Compare):
            left = self.visit(node.left)
            out = None
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)):
                    if not isinstance(comp, (ast.List, ast.Tuple)):
                        raise ValueError("query: `in` takes a list")
                    right = [self.visit(e) for e in comp.elts]
                    r = np.isin(left, right)
                    if isinstance(op, ast.NotIn):
                        r = ~r
                elif type(op) in self._CMP:
                    right = self.visit(comp)
                    r = self._CMP[type(op)](left, right)
                else:
                    break
                out = r if out is None else np.logical_and(out, r)
                left = right
            else:
                return out
        raise ValueError(f"query: unsupported syntax {ast.dump(node)[:60]}")


# ---------------------------------------------------------------------
_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
EMBEDDED_DBS = ("metabolites_hmdb_core", "compounds_chebi_core")


def load_embedded_dbs() -> dict:
    """The embedded molecule databases shipped with the package (the
    reference's embedded HMDB + ChEBI DBs loaded at startup,
    src/state.rs:88-104). Keys: EMBEDDED_DBS; values: MolDb (metabolites
    with names + descriptor columns). The .npz tables are converted from
    the JAX package's parquet by scripts/convert_embedded_dbs.py."""
    out = {}
    for name in EMBEDDED_DBS:
        path = os.path.join(_DATA_DIR, f"{name}.npz")
        if os.path.exists(path):
            out[name] = MolDb.open(path)
    return out


def lookup_by_name(name: str, dbs: Optional[dict] = None):
    """Case-insensitive name lookup across the embedded DBs; returns a
    (db_name, Row) pair or None."""
    dbs = dbs if dbs is not None else load_embedded_dbs()
    for db_name, db in dbs.items():
        if "name" not in db.columns:
            continue
        hit = np.nonzero(np.char.lower(db["name"]) == name.lower())[0]
        if len(hit):
            return db_name, db.row(int(hit[0]))
    return None
