"""Element data: masses, covalent radii, vdW radii (public standard values).

Copy of molchanica_tpu.molecules.elements:
the same host code, so its results equal the reference's bit for bit.

Mirrors the role of the reference's Element enum usage across
src/molecules/mod.rs; data here is the standard periodic-table values needed
by parsers, bond inference, and system builders.
"""
from __future__ import annotations

ELEMENT_MASSES = {
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.098, "Ca": 40.078,
    "Mn": 54.938, "Fe": 55.845, "Co": 58.933, "Ni": 58.693, "Cu": 63.546,
    "Zn": 65.38, "Se": 78.971, "Br": 79.904, "I": 126.90,
}

# single-bond covalent radii (A), Pyykko & Atsumi 2009 rounded
COVALENT_RADII = {
    "H": 0.32, "B": 0.85, "C": 0.75, "N": 0.71, "O": 0.63, "F": 0.64,
    "Na": 1.55, "Mg": 1.39, "Si": 1.16, "P": 1.11, "S": 1.03, "Cl": 0.99,
    "K": 1.96, "Ca": 1.71, "Fe": 1.16, "Zn": 1.18, "Se": 1.16, "Br": 1.14,
    "I": 1.33,
}

VDW_RADII = {
    "H": 1.10, "C": 1.70, "N": 1.55, "O": 1.52, "F": 1.47, "P": 1.80,
    "S": 1.80, "Cl": 1.75, "Br": 1.85, "I": 1.98, "Na": 2.27, "K": 2.75,
    "Mg": 1.73, "Ca": 2.31, "Zn": 1.39, "Fe": 1.63, "Se": 1.90,
}


def element_mass(symbol: str) -> float:
    return ELEMENT_MASSES[normalize_symbol(symbol)]


def normalize_symbol(symbol: str) -> str:
    s = symbol.strip()
    if not s:
        raise ValueError("empty element symbol")
    return s[0].upper() + s[1:].lower()
