"""Parsers for Amber parameter files: parm*.dat and .frcmod.

Copy of molchanica_tpu.ff.amber_dat:
the same host code, so its results equal the reference's bit for bit.

Equivalent of the loading half of the reference's `FfParamSet::new_amber`
(src/main.rs:169; the files themselves live in the unmounted
`dynamics` crate). Format reference: the public AMBER parm.dat / frcmod
specification (fixed 2-character type fields joined by '-').

Energy conventions stored:
  bond     E = k (r - r0)^2                 (k as-is from file)
  angle    E = k (th - th0)^2               (th0 converted deg -> rad)
  dihedral E = (PK/IDIVF)(1 + cos(PN*phi - PHASE))  (k stored pre-divided)
  improper E = PK (1 + cos(PN*phi - PHASE))
  nonbond  (rmin/2, eps) pairs, sigma = 2 * rmin2 / 2^(1/6)
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEG = math.pi / 180.0
RMIN2_TO_SIGMA = 2.0 / 2.0 ** (1.0 / 6.0)


@dataclass
class DihedralTerm:
    k: float          # PK / IDIVF
    periodicity: float
    phase: float      # radians


@dataclass
class ForceFieldParams:
    """One parameter set (e.g. GAFF2, ff19SB, lipid21, or a frcmod patch)."""
    masses: Dict[str, float] = field(default_factory=dict)
    bonds: Dict[Tuple[str, str], Tuple[float, float]] = field(default_factory=dict)
    angles: Dict[Tuple[str, str, str], Tuple[float, float]] = field(default_factory=dict)
    dihedrals: Dict[Tuple[str, str, str, str], List[DihedralTerm]] = field(default_factory=dict)
    impropers: Dict[Tuple[str, str, str, str], List[DihedralTerm]] = field(default_factory=dict)
    nonbonded: Dict[str, Tuple[float, float]] = field(default_factory=dict)  # rmin/2, eps
    equivalences: Dict[str, str] = field(default_factory=dict)
    title: str = ""

    # ---- lookups with canonical ordering + wildcards ----
    def bond(self, t1, t2):
        return self.bonds.get((t1, t2)) or self.bonds.get((t2, t1))

    def angle(self, t1, t2, t3):
        return self.angles.get((t1, t2, t3)) or self.angles.get((t3, t2, t1))

    def dihedral(self, t1, t2, t3, t4):
        for key in ((t1, t2, t3, t4), (t4, t3, t2, t1),
                    ("X", t2, t3, "X"), ("X", t3, t2, "X")):
            if key in self.dihedrals:
                return self.dihedrals[key]
        return None

    def improper(self, t1, t2, t3, t4):
        """Amber improper: third atom is central; wildcards in slots 1/2."""
        perms = [(t1, t2, t3, t4), (t2, t1, t3, t4),
                 (t1, t4, t3, t2), (t4, t1, t3, t2),
                 (t2, t4, t3, t1), (t4, t2, t3, t1)]
        for a, b, c, d in perms:
            for key in ((a, b, c, d), ("X", b, c, d), ("X", a, c, d),
                        ("X", "X", c, d)):
                if key in self.impropers:
                    return self.impropers[key]
        return None

    def lj(self, t):
        t = self.equivalences.get(t, t)
        return self.nonbonded.get(t)

    def lj_sigma_eps(self, t):
        v = self.lj(t)
        if v is None:
            return None
        rmin2, eps = v
        return rmin2 * RMIN2_TO_SIGMA, eps


def _ty(field_str: str) -> str:
    return field_str.strip()


def _split_types(spec: str, n: int) -> List[str]:
    """Split 'c3-c3-oh' style fixed-width type field (2 chars + '-')."""
    # fixed columns: each type occupies 2 chars, separated by '-'
    parts = []
    for i in range(n):
        start = i * 3
        parts.append(_ty(spec[start:start + 2]))
    return parts


_NUM = re.compile(r"[-+]?\d*\.?\d+(?:[eEdD][-+]?\d+)?")


def _nums(s: str, count: int) -> List[float]:
    vals = _NUM.findall(s)
    return [float(v.replace("D", "e").replace("d", "e")) for v in vals[:count]]


def _parse_bond_line(line, out: ForceFieldParams):
    types = _split_types(line, 2)
    if not all(types):
        return
    vals = _nums(line[5:], 2)
    if len(vals) == 2:
        out.bonds[(types[0], types[1])] = (vals[0], vals[1])


def _parse_angle_line(line, out):
    types = _split_types(line, 3)
    if not all(types):
        return
    vals = _nums(line[8:], 2)
    if len(vals) == 2:
        out.angles[(types[0], types[1], types[2])] = (vals[0], vals[1] * DEG)


def _parse_dihedral_line(line, out, pending: dict):
    types = tuple(_split_types(line, 4))
    if not all(types):
        return
    vals = _nums(line[11:], 4)
    if len(vals) < 4:
        return
    idivf, pk, phase, pn = vals
    term = DihedralTerm(k=pk / max(idivf, 1.0), periodicity=abs(pn),
                        phase=phase * DEG)
    key = pending.pop("key", None)
    if key is not None and key == types:
        out.dihedrals[types].append(term)
    else:
        out.dihedrals[types] = [term]
    if pn < 0:   # negative PN: additional terms for same torsion follow
        pending["key"] = types
    else:
        pending.pop("key", None)


def _parse_improper_line(line, out):
    types = tuple(_split_types(line, 4))
    if not all(types):
        return
    vals = _nums(line[11:], 3)
    if len(vals) < 3:
        return
    pk, phase, pn = vals
    out.impropers.setdefault(types, []).append(
        DihedralTerm(k=pk, periodicity=abs(pn), phase=phase * DEG))


def _parse_mass_line(line, out):
    t = _ty(line[:2])
    if not t:
        return
    vals = _nums(line[2:], 1)
    if vals:
        out.masses[t] = vals[0]


def _parse_nonb_line(line, out):
    parts = line.split()
    if len(parts) >= 3:
        try:
            out.nonbonded[parts[0]] = (float(parts[1]), float(parts[2]))
        except ValueError:
            pass


def parse_frcmod(text: str) -> ForceFieldParams:
    """Parse an frcmod (force-field modification) file."""
    out = ForceFieldParams()
    section = None
    pending: dict = {}
    lines = text.splitlines()
    out.title = lines[0].strip() if lines else ""
    for line in lines[1:]:
        u = line.strip().upper()
        if not line.strip():
            section = None
            pending.clear()
            continue
        if u.startswith(("MASS", "BOND", "ANGL", "DIHE", "IMPR", "NONB",
                         "HBON", "CMAP", "LJED")):
            section = u[:4]
            pending.clear()
            continue
        if section == "MASS":
            _parse_mass_line(line, out)
        elif section == "BOND":
            _parse_bond_line(line, out)
        elif section == "ANGL":
            _parse_angle_line(line, out)
        elif section == "DIHE":
            _parse_dihedral_line(line, out, pending)
        elif section == "IMPR":
            _parse_improper_line(line, out)
        elif section == "NONB":
            _parse_nonb_line(line, out)
    return out


def parse_dat(text: str) -> ForceFieldParams:
    """Parse a full parm*.dat main parameter file (sequential sections,
    tolerant of extra blank lines between sections)."""
    out = ForceFieldParams()
    lines = text.splitlines()
    out.title = lines[0].strip() if lines else ""
    i = 1
    n = len(lines)

    def skip_blanks(i):
        while i < n and not lines[i].strip():
            i += 1
        return i

    def section(i, handler):
        i = skip_blanks(i)
        while i < n and lines[i].strip():
            handler(lines[i])
            i += 1
        return i

    # MASS section
    i = section(i, lambda l: _parse_mass_line(l, out))
    # hydrophilic types line — single line, skip
    i = skip_blanks(i)
    if i < n:
        i += 1
    i = section(i, lambda l: _parse_bond_line(l, out))
    i = section(i, lambda l: _parse_angle_line(l, out))
    pending: dict = {}
    i = section(i, lambda l: _parse_dihedral_line(l, out, pending))
    i = section(i, lambda l: _parse_improper_line(l, out))
    # 10-12 H-bond section — skip
    i = section(i, lambda l: None)

    # vdW equivalences: "TYPE  EQ1 EQ2 ..."
    def eq_handler(l):
        parts = l.split()
        if len(parts) >= 2:
            for eq in parts[1:]:
                out.equivalences[eq] = parts[0]
    i = section(i, eq_handler)

    # "MOD4      RE" header then LJ lines until blank/END
    i = skip_blanks(i)
    if i < n and "MOD4" in lines[i].upper():
        i += 1
    while i < n:
        s = lines[i].strip()
        if not s or s.upper() == "END":
            break
        _parse_nonb_line(lines[i], out)
        i += 1
    return out
