"""PyMol-style atom selection language.

Copy of molchanica_tpu.selection:
the same host code, so its results equal the reference's bit for bit.

Counterpart of src/selection.rs (1449 LoC: atom/bond/
residue selection model + PyMol-style queries): a recursive-descent parser
and evaluator for selection expressions over molecule metadata.

Grammar (PyMol subset):

    expr     := or_expr
    or_expr  := and_expr (("or" | "|") and_expr)*
    and_expr := not_expr (("and" | "&") not_expr)*
    not_expr := ("not" | "!") not_expr | primary
    primary  := "(" expr ")"
              | "all" | "none" | "hetatm" | "polymer" | "hydro"
              | "resn" NAMELIST   | "resi" RANGELIST | "elem" NAMELIST
              | "name" NAMELIST   | "chain" NAMELIST | "index" RANGELIST
              | expr "within" FLOAT "of" primary   (handled as primary:
                "within" FLOAT "of" primary selects atoms near that set)
              | "byres" primary   (expand to whole residues)

NAMELIST  = name(+name)*      e.g. resn ALA+GLY
RANGELIST = n(-m)?(+...)*     e.g. resi 1-10+25

Evaluates to a boolean mask over atoms. Metadata fields default
sensibly when a molecule lacks them (chain "A", resn "UNL", ...).
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np


class SelectionError(ValueError):
    pass


_TOKEN = re.compile(r"\(|\)|[^\s()]+")
_WORDS = {"or", "|", "and", "&", "not", "!", "all", "none", "hetatm",
          "polymer", "hydro", "resn", "resi", "elem", "name", "chain",
          "index", "within", "of", "byres"}


class _Atoms:
    """Normalized metadata view over a MoleculeCommon-like object."""

    def __init__(self, mol):
        n = mol.n_atoms
        self.n = n
        self.elements = [str(e).upper() for e in mol.elements]
        self.positions = np.asarray(mol.positions, np.float64)
        names = getattr(mol, "atom_names", None)
        self.names = ([str(s).upper() for s in names] if names
                      else [f"{e}{i+1}".upper()
                            for i, e in enumerate(mol.elements)])
        resn = getattr(mol, "res_names", None)
        self.resn = ([str(s).upper() for s in resn] if resn
                     else ["UNL"] * n)
        resi = getattr(mol, "res_ids", None)
        self.resi = (np.asarray(resi, np.int64) if resi is not None
                     and len(np.atleast_1d(resi)) == n
                     else np.ones(n, np.int64))
        chains = getattr(mol, "chains", None)
        self.chains = ([str(c).upper() for c in chains] if chains
                       else ["A"] * n)
        het = getattr(mol, "hetero", None)
        self.het = (np.asarray(het, bool) if het is not None
                    and len(np.atleast_1d(het)) == n
                    else np.zeros(n, bool))


def _parse_ranges(tok: str):
    out = []
    for part in tok.split("+"):
        m = re.match(r"^(-?\d+)(?:-(-?\d+))?$", part)
        if not m:
            raise SelectionError(f"bad range {part!r}")
        a = int(m.group(1))
        b = int(m.group(2)) if m.group(2) else a
        out.append((a, b))
    return out


class _Parser:
    def __init__(self, text: str, atoms: _Atoms):
        self.toks = _TOKEN.findall(text)
        self.i = 0
        self.a = atoms

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise SelectionError("unexpected end of selection")
        self.i += 1
        return t

    def parse(self) -> np.ndarray:
        m = self.or_expr()
        if self.peek() is not None:
            raise SelectionError(f"trailing tokens at {self.peek()!r}")
        return m

    def or_expr(self):
        m = self.and_expr()
        while self.peek() in ("or", "|"):
            self.next()
            m = m | self.and_expr()
        return m

    def and_expr(self):
        m = self.not_expr()
        while True:
            t = self.peek()
            if t in ("and", "&"):
                self.next()
                m = m & self.not_expr()
            # implicit AND when two primaries follow each other (PyMol
            # treats "resn ALA name CA" as an intersection)
            elif t is not None and t not in (")", "or", "|") \
                    and t != "of":
                m = m & self.not_expr()
            else:
                return m

    def not_expr(self):
        if self.peek() in ("not", "!"):
            self.next()
            return ~self.not_expr()
        return self.primary()

    def primary(self):
        a = self.a
        t = self.next()
        if t == "(":
            m = self.or_expr()
            if self.next() != ")":
                raise SelectionError("missing ')'")
            return m
        if t == "all":
            return np.ones(a.n, bool)
        if t == "none":
            return np.zeros(a.n, bool)
        if t == "hetatm":
            return a.het.copy()
        if t == "polymer":
            return ~a.het
        if t == "hydro":
            return np.asarray([e == "H" for e in a.elements])
        if t == "byres":
            inner = self.primary()
            keys = {(a.chains[i], int(a.resi[i]))
                    for i in np.where(inner)[0]}
            return np.asarray([(a.chains[i], int(a.resi[i])) in keys
                               for i in range(a.n)])
        if t == "within":
            r = float(self.next())
            if self.next() != "of":
                raise SelectionError("within <r> of <sel>")
            ref = self.primary()
            if not ref.any():
                return np.zeros(a.n, bool)
            d = np.linalg.norm(
                a.positions[:, None, :] - a.positions[None, ref, :],
                axis=-1)
            return d.min(axis=1) <= r
        if t == "resn":
            names = set(self.next().upper().split("+"))
            return np.asarray([s in names for s in a.resn])
        if t == "elem":
            names = set(self.next().upper().split("+"))
            return np.asarray([e in names for e in a.elements])
        if t == "name":
            names = set(self.next().upper().split("+"))
            return np.asarray([s in names for s in a.names])
        if t == "chain":
            names = set(self.next().upper().split("+"))
            return np.asarray([c in names for c in a.chains])
        if t == "resi":
            rng = _parse_ranges(self.next())
            return np.asarray([any(lo <= v <= hi for lo, hi in rng)
                               for v in a.resi])
        if t == "index":
            rng = _parse_ranges(self.next())
            idx = np.arange(a.n)
            return np.asarray([any(lo <= v <= hi for lo, hi in rng)
                               for v in idx])
        raise SelectionError(f"unknown selection token {t!r}")


def select(mol, expr: str) -> np.ndarray:
    """Evaluate a PyMol-style selection over a molecule; returns a boolean
    mask [n_atoms]."""
    expr = expr.strip()
    if not expr:
        raise SelectionError("empty selection")
    return _Parser(expr.lower(), _Atoms(mol)).parse()


def select_indices(mol, expr: str) -> List[int]:
    return [int(i) for i in np.where(select(mol, expr))[0]]
