"""Amber prmtop / inpcrd readers -> parameterized MolSpec.

Copy of molchanica_tpu.io.prmtop:
the same host code, so its results equal the reference's bit for bit.

Reference parity: the reference consumes Amber parameter files at startup
(FfParamSet::new_amber + .dat/.frcmod parsers). A prmtop carries the
FULLY-ASSIGNED topology (charges, LJ, bonded terms, exclusions), so
loading one gives production-exact parameters from ambertools for any
system — bypassing the embedded approximate subsets entirely.

Format: the standard %FLAG/%FORMAT sectioned text (AmberTools, public
spec). Charges are stored scaled by 18.2223 (sqrt of the Amber Coulomb
constant); LJ comes from the ACOEF/BCOEF tables via the type index matrix;
dihedral sign conventions: third index < 0 -> skip the 1-4 pair (ring or
multiterm duplicate), fourth index < 0 -> improper.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..molecules.spec import MolSpec

AMBER_CHARGE_SCALE = 18.2223


def _parse_sections(text: str) -> Dict[str, List[str]]:
    sections: Dict[str, List[str]] = {}
    cur = None
    fmt_width = None
    for line in text.splitlines():
        if line.startswith("%FLAG"):
            cur = line.split()[1].strip()
            sections[cur] = []
            fmt_width = None
        elif line.startswith("%FORMAT"):
            m = re.search(r"\((\d+)([aIEFed])([\d.]+)", line)
            if m:
                fmt_width = (int(m.group(1)), m.group(2).lower(),
                             m.group(3))
            if cur is not None:
                sections[cur + "__fmt"] = [line]
        elif line.startswith("%"):
            continue
        elif cur is not None:
            sections[cur].append(line.rstrip("\n"))
    return sections


def _ints(sections, flag) -> np.ndarray:
    return np.asarray([int(v) for ln in sections.get(flag, [])
                       for v in ln.split()], np.int64)


def _floats(sections, flag) -> np.ndarray:
    return np.asarray([float(v) for ln in sections.get(flag, [])
                       for v in ln.split()], np.float64)


def _strs(sections, flag, width=4) -> List[str]:
    out = []
    for ln in sections.get(flag, []):
        for c in range(0, len(ln), width):
            s = ln[c:c + width].strip()
            if s or c + width <= len(ln.rstrip()):
                out.append(s)
    return [s for s in out if s]


def read_prmtop(path, coords: Optional[np.ndarray] = None) -> MolSpec:
    """Parse a prmtop into a fully-parameterized MolSpec.

    coords: [n,3] A (e.g. from read_inpcrd); zeros if omitted.
    """
    sec = _parse_sections(open(path).read())
    ptr = _ints(sec, "POINTERS")
    natom = int(ptr[0])
    ntypes = int(ptr[1])

    charges = _floats(sec, "CHARGE") / AMBER_CHARGE_SCALE
    masses = _floats(sec, "MASS")
    tindex = _ints(sec, "ATOM_TYPE_INDEX") - 1          # [natom]
    nb_parm = _ints(sec, "NONBONDED_PARM_INDEX")        # [ntypes^2]
    acoef = _floats(sec, "LENNARD_JONES_ACOEF")
    bcoef = _floats(sec, "LENNARD_JONES_BCOEF")

    # per-type sigma/eps from the diagonal
    sig_t = np.zeros(ntypes)
    eps_t = np.zeros(ntypes)
    for t in range(ntypes):
        k = int(nb_parm[t * ntypes + t]) - 1
        a, b = (acoef[k], bcoef[k]) if k >= 0 else (0.0, 0.0)
        if a > 0 and b > 0:
            sig_t[t] = (a / b) ** (1.0 / 6.0)
            eps_t[t] = b * b / (4.0 * a)
    lj_sigma = sig_t[tindex]
    lj_eps = eps_t[tindex]

    bond_k = _floats(sec, "BOND_FORCE_CONSTANT")
    bond_r0 = _floats(sec, "BOND_EQUIL_VALUE")
    ang_k = _floats(sec, "ANGLE_FORCE_CONSTANT")
    ang_t0 = _floats(sec, "ANGLE_EQUIL_VALUE")
    dih_k = _floats(sec, "DIHEDRAL_FORCE_CONSTANT")
    dih_n = _floats(sec, "DIHEDRAL_PERIODICITY")
    dih_p = _floats(sec, "DIHEDRAL_PHASE")
    scee = _floats(sec, "SCEE_SCALE_FACTOR")
    scnb = _floats(sec, "SCNB_SCALE_FACTOR")

    bonds = []
    for arr_name in ("BONDS_INC_HYDROGEN", "BONDS_WITHOUT_HYDROGEN"):
        arr = _ints(sec, arr_name)
        for s in range(0, len(arr), 3):
            i, j, k = arr[s] // 3, arr[s + 1] // 3, arr[s + 2] - 1
            bonds.append((int(i), int(j), float(bond_k[k]),
                          float(bond_r0[k])))
    angles = []
    for arr_name in ("ANGLES_INC_HYDROGEN", "ANGLES_WITHOUT_HYDROGEN"):
        arr = _ints(sec, arr_name)
        for s in range(0, len(arr), 4):
            i, j, kk, p = (arr[s] // 3, arr[s + 1] // 3, arr[s + 2] // 3,
                           arr[s + 3] - 1)
            angles.append((int(i), int(j), int(kk), float(ang_k[p]),
                           float(ang_t0[p])))
    dihedrals = []
    pairs14 = {}
    for arr_name in ("DIHEDRALS_INC_HYDROGEN",
                     "DIHEDRALS_WITHOUT_HYDROGEN"):
        arr = _ints(sec, arr_name)
        for s in range(0, len(arr), 5):
            i = arr[s] // 3
            j = arr[s + 1] // 3
            k_raw = arr[s + 2]
            l_raw = arr[s + 3]
            p = arr[s + 4] - 1
            k = abs(k_raw) // 3
            l = abs(l_raw) // 3
            if dih_k[p] != 0.0:
                dihedrals.append((int(i), int(j), int(k), int(l),
                                  float(dih_k[p]), float(dih_n[p]),
                                  float(dih_p[p])))
            # 1-4 pair bookkeeping: skip if k_raw < 0 (dup/ring) or
            # improper (l_raw < 0)
            if k_raw >= 0 and l_raw >= 0:
                key = (min(int(i), int(l)), max(int(i), int(l)))
                se = float(scee[p]) if len(scee) else 1.2
                sn = float(scnb[p]) if len(scnb) else 2.0
                pairs14[key] = (se if se > 0 else 1.2,
                                sn if sn > 0 else 2.0)

    # exclusions from the prmtop's own exclusion list
    n_excl = _ints(sec, "NUMBER_EXCLUDED_ATOMS")
    excl_list = _ints(sec, "EXCLUDED_ATOMS_LIST")
    exclusions = set()
    off = 0
    for i in range(natom):
        cnt = int(n_excl[i]) if len(n_excl) else 0
        for e in excl_list[off:off + cnt]:
            j = int(e) - 1
            if j >= 0:
                exclusions.add((min(i, j), max(i, j)))
        off += cnt
    # 1-4s are part of the Amber exclusion list; our MolSpec keeps them
    # separate (pairs14 re-adds the scaled interaction)
    pos = np.zeros((natom, 3)) if coords is None else \
        np.asarray(coords, float)

    # H-constraint clusters from bonds
    hclusters: Dict[int, Tuple[List[int], List[float]]] = {}
    is_h = masses < 2.0
    for (i, j, kk, r0) in bonds:
        hi, hj = bool(is_h[i]), bool(is_h[j])
        if hi != hj:
            heavy, h = (j, i) if hi else (i, j)
            hclusters.setdefault(heavy, ([], []))
            hclusters[heavy][0].append(h)
            hclusters[heavy][1].append(r0)

    return MolSpec(
        masses=masses, charges=charges, lj_sigma=lj_sigma, lj_eps=lj_eps,
        positions=pos, bonds=bonds, angles=angles, dihedrals=dihedrals,
        pairs14=[(i, j, se, sn) for (i, j), (se, sn)
                 in sorted(pairs14.items())],
        exclusions=sorted(exclusions - set(pairs14)),
        hclusters=[(h, hs, r0s) for h, (hs, r0s)
                   in sorted(hclusters.items())],
        ff_mol_type="peptide")


def read_inpcrd(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Amber restart/coordinate file -> (coords [n,3] A, box or None)."""
    lines = open(path).read().splitlines()
    header = lines[1].split()
    n = int(header[0])
    vals: List[float] = []
    for ln in lines[2:]:
        for c in range(0, len(ln), 12):
            s = ln[c:c + 12].strip()
            if s:
                vals.append(float(s))
    coords = np.asarray(vals[: 3 * n]).reshape(n, 3)
    rest = vals[3 * n:]
    box = None
    # velocities (3n) may precede the box; a box is present only when the
    # remainder is exactly 6 values (box alone) or 3n+6 (velocities + box).
    # A velocities-only restart has len(rest) == 3n and carries no box —
    # its last six values are velocity components, not box dimensions.
    if len(rest) == 6 or len(rest) == 3 * n + 6:
        box = np.asarray(rest[-6:-3])
    return coords, box
