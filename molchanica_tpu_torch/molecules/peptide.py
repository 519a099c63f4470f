"""Peptide preparation: mmCIF/PDB protein -> parameterized MolSpec.

Copy of molchanica_tpu.molecules.peptide:
the same host code, so its results equal the reference's bit for bit.

The reference pipeline (prepare_peptide_mmcif + filter_peptide_atoms +
FfParamSet peptide typing, src/md/mod.rs:172,1076 and
src/md/prep.rs) turned a downloaded structure into a runnable MD system:
residue template matching, hydrogen population, parameter assignment.
This is the TPU-framework equivalent built on the embedded ff14SB-family
subset (ff/data/protein_ff14sb.py).

Usage:
    mol  = io.open_file("protein.cif")          # or read_pdb / read_mmcif
    spec = prepare_peptide(mol)                 # MolSpec, H's populated
    asys = assemble_system([spec], water_model=OPC, ...)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ff.data.protein_ff14sb import (
    CTERM_PATCH,
    NTERM_PATCH,
    PROTEIN_FF,
    RESIDUE_ALIASES,
    RESIDUE_TEMPLATES,
)
from ..ff.params import assign_params
from .common import MoleculeCommon
from .geometry import find_planar_posits, find_tetra_posits
from .spec import MolSpec


class PeptideError(ValueError):
    pass


# H bond lengths by parent element
_H_LEN = {"C": 1.09, "N": 1.01, "O": 0.96, "S": 1.34}

# parent heavy atom of each template H (derived from template bonds)
def _h_parents(tpl) -> Dict[str, str]:
    atoms = tpl["atoms"]
    names = [a[0] for a in atoms]
    out = {}
    for i, j in tpl["bonds"]:
        ni, nj = names[i], names[j]
        if ni.startswith("H"):
            out[ni] = nj
        elif nj.startswith("H"):
            out[nj] = ni
    return out


_ALT_H_NAMES = {
    # PDB v2 vs v3 hydrogen naming (1HB/HB1 etc.) handled generically below
}


def _canon_h(name: str) -> str:
    """1HB2 -> HB21-style normalization: leading digit moves to the end."""
    if name and name[0].isdigit():
        return name[1:] + name[0]
    return name


def _residue_groups(mol: MoleculeCommon):
    """Split into (chain, res_id) groups preserving order."""
    groups: List[Tuple[Tuple[str, int], str, List[int]]] = []
    key_to_idx = {}
    chains = mol.chains or ["A"] * mol.n_atoms
    resi = mol.res_ids or [1] * mol.n_atoms
    resn = mol.res_names or ["UNL"] * mol.n_atoms
    for i in range(mol.n_atoms):
        k = (chains[i], resi[i])
        if k not in key_to_idx:
            key_to_idx[k] = len(groups)
            groups.append((k, resn[i], []))
        groups[key_to_idx[k]][2].append(i)
    return groups


def filter_peptide_atoms(mol: MoleculeCommon) -> MoleculeCommon:
    """Drop waters, ions, and hetero ligands — keep standard residues
    (reference filter_peptide_atoms, src/md/mod.rs:172)."""
    keep = []
    resn = mol.res_names or []
    for i in range(mol.n_atoms):
        rn = RESIDUE_ALIASES.get(resn[i], resn[i]) if resn else ""
        if rn in RESIDUE_TEMPLATES:
            keep.append(i)
    if not keep:
        raise PeptideError("no standard amino-acid residues found")
    sel = np.asarray(keep)

    def pick(lst):
        return [lst[i] for i in keep] if lst else None

    return MoleculeCommon(
        elements=[mol.elements[i] for i in keep],
        positions=np.asarray(mol.positions)[sel],
        bonds=[], atom_names=pick(mol.atom_names),
        res_names=pick(mol.res_names), res_ids=pick(mol.res_ids),
        chains=pick(mol.chains), hetero=pick(mol.hetero), name=mol.name)


def prepare_peptide(mol: MoleculeCommon, neutral_termini: bool = False,
                    strict: bool = False) -> MolSpec:
    """Template-match + populate hydrogens + assign parameters.

    Returns one MolSpec covering all chains (inter-chain gaps are left
    unbonded). Charged termini (-NH3+/-COO-) by default.
    """
    mol = filter_peptide_atoms(mol)
    groups = _residue_groups(mol)

    names: List[str] = []
    types: List[str] = []
    charges: List[float] = []
    elements: List[str] = []
    positions: List[np.ndarray] = []
    bonds: List[Tuple[int, int]] = []
    res_first: List[int] = []       # global index of each residue's N
    res_names_out: List[str] = []

    chain_of: List[str] = []

    for g, ((ch, rid), rn, atom_ids) in enumerate(groups):
        rn_c = RESIDUE_ALIASES.get(rn, rn)
        tpl = RESIDUE_TEMPLATES[rn_c]
        t_atoms = tpl["atoms"]
        t_names = [a[0] for a in t_atoms]
        t_index = {n: k for k, n in enumerate(t_names)}
        h_parent = _h_parents(tpl)

        # map input atoms onto the template by name
        have: Dict[str, int] = {}
        for i in atom_ids:
            nm = _canon_h(mol.atom_names[i])
            if nm in t_index and nm not in have:
                have[nm] = i
            elif nm == "OXT":
                have["OXT"] = i
        missing_heavy = [n for n in t_names
                         if not n.startswith("H") and n not in have]
        if missing_heavy and strict:
            raise PeptideError(
                f"residue {rn}{rid}/{ch}: missing heavy atoms "
                f"{missing_heavy}")

        base = len(names)
        res_first.append(base)
        res_names_out.append(rn_c)
        local: Dict[str, int] = {}
        # 1) heavy atoms (template order) that exist in the input
        for nm, ty, q in t_atoms:
            if nm.startswith("H"):
                continue
            if nm not in have:
                if strict:
                    raise PeptideError(f"{rn}{rid}: missing {nm}")
                continue
            local[nm] = len(names)
            names.append(nm)
            types.append(ty)
            charges.append(q)
            elements.append(mol.elements[have[nm]])
            positions.append(np.asarray(mol.positions[have[nm]], float))
            chain_of.append(ch)
        # 2) hydrogens: reuse input coordinates when present, else place
        for nm, ty, q in t_atoms:
            if not nm.startswith("H"):
                continue
            parent = h_parent.get(nm)
            if parent is None or parent not in local:
                continue
            local[nm] = len(names)
            names.append(nm)
            types.append(ty)
            charges.append(q)
            elements.append("H")
            chain_of.append(ch)
            if nm in have:
                positions.append(np.asarray(mol.positions[have[nm]], float))
            else:
                positions.append(None)      # placed in the geometry pass
        # template bonds among present atoms
        for i, j in tpl["bonds"]:
            a, b = t_names[i], t_names[j]
            if a in local and b in local:
                bonds.append((local[a], local[b]))
        # OXT for the final residue handled in the termini pass
        if "OXT" in have:
            local["OXT"] = len(names)
            names.append("OXT")
            types.append("O2")
            charges.append(0.0)             # set by the C-term patch
            elements.append("O")
            positions.append(np.asarray(mol.positions[have["OXT"]], float))
            chain_of.append(ch)
            if "C" in local:
                bonds.append((local["C"], local["OXT"]))

    # peptide bonds C(i) - N(i+1) within each chain
    name_at = lambda r, nm: _find_in_res(names, res_first, r, nm)
    n_res = len(res_first)
    for r in range(n_res - 1):
        if chain_of[res_first[r]] != chain_of[res_first[r + 1]]:
            continue
        c_i = name_at(r, "C")
        n_j = name_at(r + 1, "N")
        if c_i is not None and n_j is not None:
            d = None
            # avoid bonding across missing segments: require < 2.0 A when
            # both coordinates are known
            if positions[c_i] is not None and positions[n_j] is not None:
                d = float(np.linalg.norm(positions[c_i] - positions[n_j]))
            if d is None or d < 2.0:
                bonds.append((c_i, n_j))

    # ---- terminal patches (first/last residue of each chain) ----
    if not neutral_termini:
        chain_bounds = {}
        for r in range(n_res):
            ch = chain_of[res_first[r]]
            if ch not in chain_bounds:
                chain_bounds[ch] = [r, r]
            chain_bounds[ch][1] = r
        for ch, (r0, r1) in chain_bounds.items():
            # N-terminus: N -> N3 (+1), add H2/H3 names later in H pass
            n_i = name_at(r0, "N")
            if n_i is not None:
                types[n_i] = NTERM_PATCH["N_type"]
                charges[n_i] = NTERM_PATCH["N_charge"]
                h_i = name_at(r0, "H")
                if h_i is not None:
                    charges[h_i] = NTERM_PATCH["H_charge"]
                # two extra protons
                for extra in ("H2", "H3"):
                    names.append(extra)
                    types.append(NTERM_PATCH["H_type"])
                    charges.append(NTERM_PATCH["H_charge"])
                    elements.append("H")
                    positions.append(None)
                    chain_of.append(ch)
                    bonds.append((n_i, len(names) - 1))
            # C-terminus: O -> O2, add OXT if absent
            c_i = name_at(r1, "C")
            o_i = name_at(r1, "O")
            if c_i is not None and o_i is not None:
                charges[c_i] = CTERM_PATCH["C_charge"]
                types[o_i] = CTERM_PATCH["O_type"]
                charges[o_i] = CTERM_PATCH["O_charge"]
                ox = _find_in_res(names, res_first, r1, "OXT")
                if ox is None:
                    names.append("OXT")
                    types.append(CTERM_PATCH["O_type"])
                    charges.append(CTERM_PATCH["O_charge"])
                    elements.append("O")
                    positions.append(None)
                    bonds.append((c_i, len(names) - 1))
                    chain_of.append(ch)
                else:
                    types[ox] = CTERM_PATCH["O_type"]
                    charges[ox] = CTERM_PATCH["O_charge"]

    # snap the total charge to the nearest integer: the terminal patches
    # change a few atoms rather than substituting the full Amber terminal
    # residue charge sets, leaving a small residual — spread it over heavy
    # atoms so assembled systems are integer-charged by construction
    total = sum(charges)
    resid = round(total) - total
    heavy = [i for i in range(len(names)) if elements[i] != "H"]
    for i in heavy:
        charges[i] += resid / len(heavy)

    # ---- geometry pass: place missing atoms ----
    positions = _place_missing(names, elements, positions, bonds)

    spec = assign_params(
        elements, types, charges, np.asarray(positions), sorted(set(
            (min(i, j), max(i, j)) for i, j in bonds)),
        PROTEIN_FF, ff_mol_type="peptide", strict=False)
    return spec


def _find_in_res(names, res_first, r, nm):
    end = res_first[r + 1] if r + 1 < len(res_first) else len(names)
    for i in range(res_first[r], end):
        if names[i] == nm:
            return i
    return None


def populate_hydrogens(mol: MoleculeCommon) -> MolSpec:
    """Reference populate_hydrogens analog: template-H completion is part
    of prepare_peptide; this is the direct entry point."""
    return prepare_peptide(mol)


def _place_missing(names, elements, positions, bonds):
    """Fill None coordinates using ideal local geometry.

    Sibling proposals are assigned clash-aware: each missing atom takes the
    remaining proposal that maximizes its minimum distance to atoms already
    placed nearby (prevents greedy chains folding back onto themselves)."""
    n = len(names)
    adj = [[] for _ in range(n)]
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)
    pos = list(positions)

    for _sweep in range(6):
        progress = False
        # per-sweep snapshot for vectorized clash scoring (atoms placed
        # mid-sweep are ~bond-length from their parent anyway)
        placed_ids = [t for t in range(n) if pos[t] is not None]
        P = np.asarray([pos[t] for t in placed_ids]) \
            if placed_ids else np.zeros((0, 3))
        id_row = {t: r for r, t in enumerate(placed_ids)}

        def _score(candidate, exclude):
            if P.shape[0] == 0:
                return 99.0
            d = np.linalg.norm(P - np.asarray(candidate)[None], axis=1)
            for t in exclude:
                r = id_row.get(t)
                if r is not None:
                    d[r] = 99.0
            return float(d.min())

        for i in range(n):
            if pos[i] is not None:
                continue
            parents = [j for j in adj[i] if pos[j] is not None]
            if not parents:
                continue
            p = parents[0]
            known = [pos[j] for j in adj[p]
                     if j != i and pos[j] is not None]
            blen = _H_LEN.get(elements[p], 1.09) if elements[i] == "H" \
                else 1.5
            missing_sib = [k for k in adj[p] if pos[k] is None]
            if elements[p] == "N" and len(adj[p]) == 3 and known:
                prop = find_planar_posits(pos[p], np.asarray(known), blen)
            else:
                prop = find_tetra_posits(
                    pos[p], np.asarray(known) if known else [], blen)
            prop = [np.asarray(q, float) for q in prop]
            exclude = set(adj[p]) | {p}
            # clash-aware assignment: farthest-from-everything first
            for k in missing_sib:
                if not prop:
                    break
                scores = [_score(q, exclude) for q in prop]
                best = int(np.argmax(scores))
                pos[k] = prop.pop(best)
                progress = True
        if not progress:
            break
    # any stragglers: place near their first parent with a small offset
    for i in range(n):
        if pos[i] is None:
            parents = [j for j in adj[i] if pos[j] is not None]
            base = pos[parents[0]] if parents else np.zeros(3)
            pos[i] = np.asarray(base) + np.array([0.5, 0.5, 0.5])
    return np.asarray(pos)


def prepare_peptide_mmcif(path, **kw) -> MolSpec:
    """Convenience: read an mmCIF file and prepare it
    (reference prepare_peptide_mmcif)."""
    from ..io.mmcif import read_mmcif
    return prepare_peptide(read_mmcif(path), **kw)


def prepare_peptide_pdb(path, **kw) -> MolSpec:
    from ..io.pdb import read_pdb
    return prepare_peptide(read_pdb(path), **kw)
