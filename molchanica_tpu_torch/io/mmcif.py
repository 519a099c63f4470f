"""mmCIF (PDBx) reader/writer — the `_atom_site` loop subset.

Copy of molchanica_tpu.io.mmcif:
the same host code, so its results equal the reference's bit for bit.

The reference treats mmCIF as its primary macromolecular format (loaded via
the bio_files crate, src/file_io/mod.rs:114+ open_file and
prepare_peptide_mmcif in the peptide pipeline). This is an independent
implementation of the PDBx/mmCIF syntax: `loop_` blocks with `_atom_site.*`
item headers followed by whitespace-delimited rows, honoring single/double
quoting and `;`-delimited multi-line values.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..molecules.common import MoleculeCommon
from ..molecules.elements import normalize_symbol


def _tokenize_row(line: str) -> List[str]:
    """Split one data row on whitespace honoring ' and " quoting."""
    out = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c.isspace():
            i += 1
            continue
        if c in "'\"":
            q = c
            j = i + 1
            while j < n:
                # closing quote must be followed by whitespace or EOL
                if line[j] == q and (j + 1 >= n or line[j + 1].isspace()):
                    break
                j += 1
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            out.append(line[i:j])
            i = j
    return out


def _iter_loop_rows(lines, start, n_fields):
    """Yield token rows for a loop body starting at `start`; rows may span
    physical lines and contain `;` multi-line values."""
    i = start
    buf: List[str] = []
    while i < len(lines):
        l = lines[i]
        s = l.strip()
        if s.startswith("#") or s.startswith("loop_") or \
                (s.startswith("_") and not buf) or s.startswith("data_"):
            break
        if s.startswith(";"):
            # multi-line value: collect until the next lone ';'
            val = [s[1:]]
            i += 1
            while i < len(lines) and not lines[i].strip().startswith(";"):
                val.append(lines[i].rstrip("\n"))
                i += 1
            buf.append("\n".join(val).strip())
            i += 1
        else:
            if s:
                buf.extend(_tokenize_row(s))
            i += 1
        while len(buf) >= n_fields:
            yield buf[:n_fields]
            buf = buf[n_fields:]
    return


def read_mmcif(path) -> MoleculeCommon:
    """Parse the first data block's `_atom_site` loop into MoleculeCommon.

    Uses auth_* identifiers when present (matching how PDB-derived tooling
    numbers residues), falling back to label_*.
    """
    lines = open(path).read().splitlines()
    i = 0
    fields: List[str] = []
    body_start = None
    while i < len(lines):
        if lines[i].strip() == "loop_":
            j = i + 1
            hdr = []
            while j < len(lines) and lines[j].strip().startswith("_"):
                hdr.append(lines[j].strip().split()[0])
                j += 1
            if hdr and hdr[0].startswith("_atom_site."):
                fields = hdr
                body_start = j
                break
            i = j
        else:
            i += 1
    if body_start is None:
        raise ValueError(f"no _atom_site loop in {path}")

    idx = {f.split(".", 1)[1]: k for k, f in enumerate(fields)}

    def col(row, *names, default=None):
        for nm in names:
            k = idx.get(nm)
            if k is not None and row[k] not in (".", "?"):
                return row[k]
        return default

    elements, pos, names, resn, resi, chains, het = \
        [], [], [], [], [], [], []
    for row in _iter_loop_rows(lines, body_start, len(fields)):
        group = col(row, "group_PDB", default="ATOM")
        x = col(row, "Cartn_x")
        y = col(row, "Cartn_y")
        z = col(row, "Cartn_z")
        if x is None:
            continue
        # skip alternate locations beyond the first
        alt = col(row, "label_alt_id", default=".")
        if alt not in (".", "?", "A", "1"):
            continue
        elem = col(row, "type_symbol", default=None)
        name = col(row, "auth_atom_id", "label_atom_id", default="X")
        if not elem:
            elem = "".join(c for c in name if c.isalpha())[:2]
        elements.append(normalize_symbol(elem))
        names.append(name)
        resn.append(col(row, "auth_comp_id", "label_comp_id", default="UNL"))
        chains.append(col(row, "auth_asym_id", "label_asym_id", default="A"))
        ri = col(row, "auth_seq_id", "label_seq_id", default="1")
        try:
            resi.append(int(ri))
        except ValueError:
            resi.append(len(resi) + 1)
        pos.append([float(x), float(y), float(z)])
        het.append(group == "HETATM")

    if not elements:
        raise ValueError(f"empty _atom_site loop in {path}")
    return MoleculeCommon(
        elements=elements, positions=np.asarray(pos), bonds=[],
        atom_names=names, res_names=resn, res_ids=resi, chains=chains,
        hetero=het, name=str(path))


def write_mmcif(mol: MoleculeCommon, path=None,
                entry_id: str = "MOLC") -> str:
    names = mol.atom_names or [f"{e}{i+1}" for i, e in
                               enumerate(mol.elements)]
    resn = mol.res_names or ["UNL"] * mol.n_atoms
    resi = mol.res_ids or [1] * mol.n_atoms
    chains = mol.chains or ["A"] * mol.n_atoms
    het = mol.hetero or [False] * mol.n_atoms
    out = [f"data_{entry_id}", "#", "loop_"]
    for f in ("group_PDB", "id", "type_symbol", "label_atom_id",
              "label_comp_id", "label_asym_id", "label_seq_id",
              "Cartn_x", "Cartn_y", "Cartn_z", "occupancy",
              "B_iso_or_equiv"):
        out.append(f"_atom_site.{f}")
    for i in range(mol.n_atoms):
        x, y, z = mol.positions[i]
        grp = "HETATM" if het[i] else "ATOM"
        nm = names[i]
        if any(ch in nm for ch in " '\""):
            nm = f'"{nm}"'
        out.append(
            f"{grp:<6s} {i+1:d} {mol.elements[i]:<2s} {nm:<4s} "
            f"{resn[i]:<3s} {chains[i]} {resi[i]:d} "
            f"{x:.3f} {y:.3f} {z:.3f} 1.00 0.00")
    out.append("#")
    text = "\n".join(out) + "\n"
    if path:
        open(path, "w").write(text)
    return text
