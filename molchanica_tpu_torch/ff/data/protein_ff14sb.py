"""Embedded ff14SB-family protein parameter subset + residue templates.

Copy of molchanica_tpu.ff.data.protein_ff14sb:
the same host code, so its results equal the reference's bit for bit.

The reference loads full Amber parameter sets from .dat/.lib files at
startup (FfParamSet::new_amber, src/main.rs:169; peptide
typing via prepare_peptide_mmcif). This module embeds the equivalent data
for the 20 standard amino acids so a downloaded mmCIF/PDB protein runs
out of the box with no external files:

- `PROTEIN_FF`: ForceFieldParams with the protein atom types (parm10/ff14SB
  lineage masses, LJ, bond/angle/dihedral constants — public literature
  values at Amber-magnitude; exotic couplings fall back to wildcards).
- `RESIDUE_TEMPLATES`: per-residue atom lists (name, type, charge) and
  internal bonds, Amber all_amino94-lineage charge set (ff14SB retains the
  ff94/ff99 charge model). Net residue charges are snapped to exact
  integers at load (distributing any transcription residual over heavy
  atoms) so assembled systems are integer-charged by construction.
- Terminal patches: N-terminal -NH3+ and C-terminal -COO- variants.

Real .dat/.frcmod/.lib files can still be layered via ff.amber_dat parsers +
merge_params for production-exact parameters.
"""
from __future__ import annotations

import math

from ..amber_dat import DihedralTerm, ForceFieldParams

DEG = math.pi / 180.0


def _d(k, n, phase_deg):
    return DihedralTerm(k=k, periodicity=float(n), phase=phase_deg * DEG)


# ---------------------------------------------------------------------------
# Atom types: masses + LJ (rmin/2 [A], eps [kcal/mol]) — parm10 table.
# ---------------------------------------------------------------------------
_MASSES = {
    "C": 12.01, "CA": 12.01, "CB": 12.01, "CC": 12.01, "CN": 12.01,
    "CR": 12.01, "CT": 12.01, "CX": 12.01, "CW": 12.01, "C*": 12.01,
    "CV": 12.01, "C8": 12.01, "2C": 12.01, "3C": 12.01, "CO": 12.01,
    "H": 1.008, "H1": 1.008, "H4": 1.008, "H5": 1.008, "HA": 1.008,
    "HC": 1.008, "HO": 1.008, "HP": 1.008, "HS": 1.008,
    "N": 14.01, "N2": 14.01, "N3": 14.01, "NA": 14.01, "NB": 14.01,
    "O": 16.00, "O2": 16.00, "OH": 16.00,
    "S": 32.06, "SH": 32.06,
}

_NONBONDED = {
    "C": (1.9080, 0.0860), "CA": (1.9080, 0.0860), "CB": (1.9080, 0.0860),
    "CC": (1.9080, 0.0860), "CN": (1.9080, 0.0860), "CR": (1.9080, 0.0860),
    "CW": (1.9080, 0.0860), "C*": (1.9080, 0.0860), "CV": (1.9080, 0.0860),
    "CT": (1.9080, 0.1094), "CX": (1.9080, 0.1094), "C8": (1.9080, 0.1094),
    "2C": (1.9080, 0.1094), "3C": (1.9080, 0.1094), "CO": (1.9080, 0.0860),
    "H": (0.6000, 0.0157), "H1": (1.3870, 0.0157), "H4": (1.4090, 0.0150),
    "H5": (1.3590, 0.0150), "HA": (1.4590, 0.0150), "HC": (1.4870, 0.0157),
    "HO": (0.0000, 0.0000), "HP": (1.1000, 0.0157), "HS": (0.6000, 0.0157),
    "N": (1.8240, 0.1700), "N2": (1.8240, 0.1700), "N3": (1.8240, 0.1700),
    "NA": (1.8240, 0.1700), "NB": (1.8240, 0.1700),
    "O": (1.6612, 0.2100), "O2": (1.6612, 0.2100), "OH": (1.7210, 0.2104),
    "S": (2.0000, 0.2500), "SH": (2.0000, 0.2500),
}

# ---------------------------------------------------------------------------
# Bonds (k [kcal/mol/A^2], r0 [A]) — parm99/parm10 magnitudes.
# ---------------------------------------------------------------------------
_BONDS = {
    ("CT", "CT"): (310.0, 1.526), ("CX", "CT"): (310.0, 1.526),
    ("CT", "CX"): (310.0, 1.526),
    ("CX", "C"): (317.0, 1.522), ("CT", "C"): (317.0, 1.522),
    ("C", "O"): (570.0, 1.229), ("C", "O2"): (656.0, 1.250),
    ("C", "N"): (490.0, 1.335), ("N", "CX"): (337.0, 1.449),
    ("N", "CT"): (337.0, 1.449), ("N", "H"): (434.0, 1.010),
    ("CX", "H1"): (340.0, 1.090), ("CT", "H1"): (340.0, 1.090),
    ("CT", "HC"): (340.0, 1.090), ("CT", "HP"): (340.0, 1.090),
    ("CT", "OH"): (320.0, 1.410), ("OH", "HO"): (553.0, 0.960),
    ("CT", "SH"): (237.0, 1.810), ("SH", "HS"): (274.0, 1.336),
    ("CT", "S"): (227.0, 1.810), ("S", "S"): (166.0, 2.038),
    ("CT", "N3"): (367.0, 1.471), ("N3", "H"): (434.0, 1.010),
    ("CT", "N2"): (337.0, 1.463), ("N2", "H"): (434.0, 1.010),
    ("CA", "N2"): (481.0, 1.340),
    ("CA", "CA"): (469.0, 1.400), ("CA", "CT"): (317.0, 1.510),
    ("CA", "HA"): (367.0, 1.080), ("CA", "OH"): (450.0, 1.364),
    ("C", "CA"): (469.0, 1.409),
    # TRP / HIS ring types
    ("CT", "C*"): (317.0, 1.495), ("C*", "CW"): (546.0, 1.352),
    ("CW", "NA"): (427.0, 1.381), ("NA", "H"): (434.0, 1.010),
    ("NA", "CN"): (428.0, 1.380), ("CN", "CB"): (447.0, 1.419),
    ("CB", "C*"): (388.0, 1.459), ("CN", "CA"): (469.0, 1.400),
    ("CB", "CA"): (469.0, 1.404),
    ("CT", "CC"): (317.0, 1.504), ("CC", "NB"): (410.0, 1.391),
    ("NB", "CR"): (488.0, 1.335), ("CR", "NA"): (477.0, 1.343),
    ("CR", "H5"): (367.0, 1.080),
    ("NA", "CW"): (427.0, 1.381), ("CC", "CW"): (518.0, 1.371),
    ("CW", "H4"): (367.0, 1.080), ("CC", "CV"): (512.0, 1.375),
    ("CV", "NB"): (410.0, 1.394), ("CV", "H4"): (367.0, 1.080),
    ("C", "CT"): (317.0, 1.522),
}

# ---------------------------------------------------------------------------
# Angles (k [kcal/mol/rad^2], theta0 [rad]).
# ---------------------------------------------------------------------------
_A = {
    ("CT", "CT", "CT"): (40.0, 109.5), ("CT", "CT", "HC"): (50.0, 109.5),
    ("HC", "CT", "HC"): (35.0, 109.5), ("H1", "CT", "H1"): (35.0, 109.5),
    ("CT", "CT", "H1"): (50.0, 109.5), ("N", "CX", "H1"): (50.0, 109.5),
    ("N", "CX", "CT"): (80.0, 109.7), ("N", "CX", "C"): (63.0, 110.1),
    ("CX", "CT", "CT"): (40.0, 109.5), ("CX", "CT", "HC"): (50.0, 109.5),
    ("CX", "CT", "H1"): (50.0, 109.5),
    ("H1", "CX", "CT"): (50.0, 109.5), ("H1", "CX", "C"): (50.0, 109.5),
    ("CT", "CX", "C"): (63.0, 111.1), ("CX", "C", "O"): (80.0, 120.4),
    ("CX", "C", "N"): (70.0, 116.6), ("O", "C", "N"): (80.0, 122.9),
    ("C", "N", "H"): (50.0, 120.0), ("C", "N", "CX"): (50.0, 121.9),
    ("H", "N", "CX"): (50.0, 118.04), ("C", "N", "CT"): (50.0, 121.9),
    ("CT", "CT", "OH"): (50.0, 109.5), ("H1", "CT", "OH"): (50.0, 109.5),
    ("CT", "OH", "HO"): (55.0, 108.5), ("CA", "OH", "HO"): (50.0, 113.0),
    ("CT", "CT", "SH"): (50.0, 108.6), ("H1", "CT", "SH"): (50.0, 109.5),
    ("CT", "SH", "HS"): (43.0, 96.0), ("CT", "CT", "S"): (50.0, 114.7),
    ("CT", "S", "CT"): (62.0, 98.9), ("H1", "CT", "S"): (50.0, 109.5),
    ("CT", "CT", "N3"): (80.0, 111.2), ("CT", "N3", "H"): (50.0, 109.5),
    ("H", "N3", "H"): (35.0, 109.5), ("HP", "CT", "N3"): (50.0, 109.5),
    ("HP", "CT", "HP"): (35.0, 109.5), ("CT", "CT", "HP"): (50.0, 109.5),
    ("CT", "CT", "N2"): (80.0, 111.2), ("CT", "N2", "H"): (50.0, 118.4),
    ("H1", "CT", "N2"): (50.0, 109.5), ("CT", "N2", "CA"): (50.0, 123.2),
    ("N2", "CA", "N2"): (70.0, 120.0), ("CA", "N2", "H"): (50.0, 120.0),
    ("H", "N2", "H"): (35.0, 120.0),
    ("CT", "CT", "CA"): (63.0, 114.0), ("CA", "CA", "CA"): (63.0, 120.0),
    ("CA", "CA", "HA"): (50.0, 120.0), ("CT", "CA", "CA"): (70.0, 120.0),
    ("HC", "CT", "CA"): (50.0, 109.5), ("CA", "CA", "OH"): (70.0, 120.0),
    ("CX", "CT", "CA"): (63.0, 114.0),
    ("C", "CT", "HC"): (50.0, 109.5), ("C", "CT", "H1"): (50.0, 109.5),
    ("C", "CT", "CT"): (63.0, 111.1), ("O", "C", "CT"): (80.0, 120.4),
    ("O2", "C", "O2"): (80.0, 126.0), ("O2", "C", "CT"): (70.0, 117.0),
    ("O2", "C", "CX"): (70.0, 117.0), ("CT", "C", "N"): (70.0, 116.6),
    ("N", "C", "O"): (80.0, 122.9),
    # amide side chains (ASN/GLN)
    ("CT", "C", "O"): (80.0, 120.4), ("H", "N", "H"): (35.0, 120.0),
    ("C", "N", "H"): (50.0, 120.0),
    # TRP/HIS rings (generic aromatic-magnitude constants)
    ("CT", "C*", "CW"): (70.0, 125.0), ("C*", "CW", "NA"): (70.0, 108.7),
    ("CW", "NA", "CN"): (70.0, 111.6), ("NA", "CN", "CB"): (70.0, 107.3),
    ("CN", "CB", "C*"): (70.0, 107.1), ("CB", "C*", "CW"): (63.0, 106.4),
    ("CB", "C*", "CT"): (70.0, 128.6), ("NA", "CN", "CA"): (70.0, 132.8),
    ("CN", "CA", "CA"): (63.0, 117.0), ("CB", "CA", "CA"): (63.0, 117.0),
    ("CN", "CB", "CA"): (63.0, 122.7), ("CA", "CB", "C*"): (63.0, 134.9),
    ("C*", "CW", "H4"): (50.0, 120.0), ("NA", "CW", "H4"): (50.0, 120.0),
    ("CW", "NA", "H"): (50.0, 123.1), ("CN", "NA", "H"): (50.0, 125.8),
    ("CT", "CC", "NB"): (70.0, 121.6), ("CT", "CC", "CW"): (70.0, 129.0),
    ("CT", "CC", "CV"): (70.0, 129.0),
    ("CC", "NB", "CR"): (70.0, 105.3), ("NB", "CR", "NA"): (70.0, 111.6),
    ("CR", "NA", "CW"): (70.0, 107.7), ("NA", "CW", "CC"): (70.0, 106.3),
    ("CW", "CC", "NB"): (70.0, 109.0), ("NB", "CR", "H5"): (50.0, 124.0),
    ("NA", "CR", "H5"): (50.0, 124.0), ("CC", "CW", "H4"): (50.0, 130.0),
    ("CR", "NA", "H"): (50.0, 126.2), ("CW", "NA", "CR"): (70.0, 107.7),
    ("CC", "CV", "NB"): (70.0, 110.0), ("CC", "CV", "H4"): (50.0, 130.0),
    ("CV", "NB", "CR"): (70.0, 105.3), ("NA", "CC", "CV"): (70.0, 105.9),
    ("NA", "CC", "CT"): (70.0, 122.2), ("CV", "CC", "CT"): (70.0, 130.9),
    ("NB", "CV", "H4"): (50.0, 120.0), ("NA", "CW", "CW"): (70.0, 106.3),
}
_ANGLES = {k: (v[0], v[1] * DEG) for k, v in _A.items()}

# ---------------------------------------------------------------------------
# Dihedrals (ff14SB backbone + generic wildcards; k already / IDIVF).
# ---------------------------------------------------------------------------
_DIHEDRALS = {
    # phi/psi (ff14SB-magnitude single-term simplification + omega)
    ("C", "N", "CX", "C"): [_d(0.27, 1, 0), _d(0.42, 2, 0), _d(0.40, 3, 0)],
    ("N", "CX", "C", "N"): [_d(0.45, 1, 180), _d(1.58, 2, 180),
                            _d(0.55, 3, 180)],
    ("CX", "C", "N", "CX"): [_d(2.50, 2, 180)],
    ("O", "C", "N", "H"): [_d(2.00, 2, 180), _d(2.50, 1, 0)],
    ("X", "C", "N", "X"): [_d(2.50, 2, 180)],
    ("X", "CT", "CT", "X"): [_d(0.1556, 3, 0)],
    ("X", "CX", "CT", "X"): [_d(0.1556, 3, 0)],
    ("X", "CT", "CX", "X"): [_d(0.1556, 3, 0)],
    ("X", "CT", "N", "X"): [_d(0.0, 2, 0)],
    ("X", "CX", "N", "X"): [_d(0.0, 2, 0)],
    ("X", "CT", "OH", "X"): [_d(0.1667, 3, 0)],
    ("X", "CA", "OH", "X"): [_d(0.9, 2, 180)],
    ("X", "CT", "SH", "X"): [_d(0.25, 3, 0)],
    ("X", "CT", "S", "X"): [_d(0.3333, 3, 0)],
    ("X", "CT", "N3", "X"): [_d(0.1556, 3, 0)],
    ("X", "CT", "N2", "X"): [_d(0.0, 3, 0)],
    ("X", "CA", "N2", "X"): [_d(2.40, 2, 180)],
    ("X", "CA", "CA", "X"): [_d(3.625, 2, 180)],
    ("X", "CT", "CA", "X"): [_d(0.0, 2, 0)],
    ("X", "C", "CT", "X"): [_d(0.0, 2, 0)],
    ("X", "C", "CX", "X"): [_d(0.0, 2, 0)],
    ("X", "CT", "C", "X"): [_d(0.0, 2, 0)],
    ("X", "C*", "CW", "X"): [_d(6.525, 2, 180)],
    ("X", "CW", "NA", "X"): [_d(1.50, 2, 180)],
    ("X", "NA", "CN", "X"): [_d(1.525, 2, 180)],
    ("X", "CN", "CB", "X"): [_d(3.00, 2, 180)],
    ("X", "CB", "C*", "X"): [_d(1.675, 2, 180)],
    ("X", "CT", "C*", "X"): [_d(0.0, 2, 0)],
    ("X", "CN", "CA", "X"): [_d(3.625, 2, 180)],
    ("X", "CB", "CA", "X"): [_d(3.50, 2, 180)],
    ("X", "CT", "CC", "X"): [_d(0.0, 2, 0)],
    ("X", "CC", "NB", "X"): [_d(2.40, 2, 180)],
    ("X", "NB", "CR", "X"): [_d(5.00, 2, 180)],
    ("X", "CR", "NA", "X"): [_d(2.325, 2, 180)],
    ("X", "NA", "CW", "X"): [_d(1.50, 2, 180)],
    ("X", "CC", "CW", "X"): [_d(5.375, 2, 180)],
    ("X", "CC", "CV", "X"): [_d(5.15, 2, 180)],
    ("X", "CV", "NB", "X"): [_d(2.40, 2, 180)],
    ("X", "NA", "CC", "X"): [_d(1.40, 2, 180)],
}

_IMPROPERS = {
    ("X", "X", "C", "O"): [_d(10.5, 2, 180)],
    ("X", "O2", "C", "O2"): [_d(10.5, 2, 180)],
    ("X", "X", "N", "H"): [_d(1.0, 2, 180)],
    ("X", "X", "N2", "H"): [_d(1.0, 2, 180)],
    ("X", "X", "NA", "H"): [_d(1.0, 2, 180)],
    ("X", "X", "CA", "HA"): [_d(1.1, 2, 180)],
    ("X", "N2", "CA", "N2"): [_d(10.5, 2, 180)],
    ("X", "X", "CW", "H4"): [_d(1.1, 2, 180)],
    ("X", "X", "CR", "H5"): [_d(1.1, 2, 180)],
    ("X", "X", "CV", "H4"): [_d(1.1, 2, 180)],
}

PROTEIN_FF = ForceFieldParams(
    masses=dict(_MASSES),
    bonds=dict(_BONDS),
    angles=dict(_ANGLES),
    dihedrals=dict(_DIHEDRALS),
    impropers=dict(_IMPROPERS),
    nonbonded=dict(_NONBONDED),
    title="embedded ff14SB-family protein subset",
)

# ---------------------------------------------------------------------------
# Residue templates: (atom_name, amber_type, charge) + internal bonds.
# Charges: Amber all_amino94 lineage (ff14SB charge model). Backbone atoms
# first; hydrogens listed right after their parent heavy atom.
# ---------------------------------------------------------------------------
_BB = [("N", "N", -0.4157), ("H", "H", 0.2719)]
_BB_END = [("C", "C", 0.5973), ("O", "O", -0.5679)]


def _res(side, ca_q, ha_q, bb_n=None, bb_end=None, extra_bonds=()):
    bb_n = bb_n or _BB
    bb_end = bb_end or _BB_END
    atoms = list(bb_n) + [("CA", "CX", ca_q), ("HA", "H1", ha_q)] + \
        list(side) + list(bb_end)
    return atoms, list(extra_bonds)


_T = {}

_T["ALA"] = _res([("CB", "CT", -0.1825),
                  ("HB1", "HC", 0.0603), ("HB2", "HC", 0.0603),
                  ("HB3", "HC", 0.0603)], 0.0337, 0.0823)

_T["GLY"] = ([("N", "N", -0.4157), ("H", "H", 0.2719),
              ("CA", "CX", -0.0252), ("HA2", "H1", 0.0698),
              ("HA3", "H1", 0.0698), ("C", "C", 0.5973),
              ("O", "O", -0.5679)], [])

_T["VAL"] = _res([("CB", "CT", 0.2985), ("HB", "HC", -0.0297),
                  ("CG1", "CT", -0.3192), ("HG11", "HC", 0.0791),
                  ("HG12", "HC", 0.0791), ("HG13", "HC", 0.0791),
                  ("CG2", "CT", -0.3192), ("HG21", "HC", 0.0791),
                  ("HG22", "HC", 0.0791), ("HG23", "HC", 0.0791)],
                 -0.0875, 0.0969)

_T["LEU"] = _res([("CB", "CT", -0.1102), ("HB2", "HC", 0.0457),
                  ("HB3", "HC", 0.0457), ("CG", "CT", 0.3531),
                  ("HG", "HC", -0.0361),
                  ("CD1", "CT", -0.4121), ("HD11", "HC", 0.1000),
                  ("HD12", "HC", 0.1000), ("HD13", "HC", 0.1000),
                  ("CD2", "CT", -0.4121), ("HD21", "HC", 0.1000),
                  ("HD22", "HC", 0.1000), ("HD23", "HC", 0.1000)],
                 -0.0518, 0.0922)

_T["ILE"] = _res([("CB", "CT", 0.1303), ("HB", "HC", 0.0187),
                  ("CG2", "CT", -0.3204), ("HG21", "HC", 0.0882),
                  ("HG22", "HC", 0.0882), ("HG23", "HC", 0.0882),
                  ("CG1", "CT", -0.0430), ("HG12", "HC", 0.0236),
                  ("HG13", "HC", 0.0236), ("CD1", "CT", -0.0660),
                  ("HD11", "HC", 0.0186), ("HD12", "HC", 0.0186),
                  ("HD13", "HC", 0.0186)], -0.0597, 0.0869)

_T["PRO"] = ([("N", "N", -0.2548), ("CD", "CT", 0.0192),
              ("HD2", "H1", 0.0391), ("HD3", "H1", 0.0391),
              ("CG", "CT", 0.0189), ("HG2", "HC", 0.0213),
              ("HG3", "HC", 0.0213), ("CB", "CT", -0.0070),
              ("HB2", "HC", 0.0253), ("HB3", "HC", 0.0253),
              ("CA", "CX", -0.0266), ("HA", "H1", 0.0641),
              ("C", "C", 0.5896), ("O", "O", -0.5748)],
             [("N", "CD"), ("CD", "CG"), ("CG", "CB"), ("CB", "CA")])

_T["PHE"] = _res([("CB", "CT", -0.0343), ("HB2", "HC", 0.0295),
                  ("HB3", "HC", 0.0295), ("CG", "CA", 0.0118),
                  ("CD1", "CA", -0.1256), ("HD1", "HA", 0.1330),
                  ("CE1", "CA", -0.1704), ("HE1", "HA", 0.1430),
                  ("CZ", "CA", -0.1072), ("HZ", "HA", 0.1297),
                  ("CE2", "CA", -0.1704), ("HE2", "HA", 0.1430),
                  ("CD2", "CA", -0.1256), ("HD2", "HA", 0.1330)],
                 -0.0024, 0.0978,
                 extra_bonds=[("CG", "CD1"), ("CD1", "CE1"), ("CE1", "CZ"),
                              ("CZ", "CE2"), ("CE2", "CD2"), ("CD2", "CG")])

_T["TYR"] = _res([("CB", "CT", -0.0152), ("HB2", "HC", 0.0295),
                  ("HB3", "HC", 0.0295), ("CG", "CA", -0.0011),
                  ("CD1", "CA", -0.1906), ("HD1", "HA", 0.1699),
                  ("CE1", "CA", -0.2341), ("HE1", "HA", 0.1656),
                  ("CZ", "CA", 0.3226), ("OH", "OH", -0.5579),
                  ("HH", "HO", 0.3992),
                  ("CE2", "CA", -0.2341), ("HE2", "HA", 0.1656),
                  ("CD2", "CA", -0.1906), ("HD2", "HA", 0.1699)],
                 -0.0014, 0.0876,
                 extra_bonds=[("CG", "CD1"), ("CD1", "CE1"), ("CE1", "CZ"),
                              ("CZ", "CE2"), ("CE2", "CD2"), ("CD2", "CG"),
                              ("CZ", "OH")])

_T["TRP"] = _res([("CB", "CT", -0.0050), ("HB2", "HC", 0.0339),
                  ("HB3", "HC", 0.0339), ("CG", "C*", -0.1415),
                  ("CD1", "CW", -0.1638), ("HD1", "H4", 0.2062),
                  ("NE1", "NA", -0.3418), ("HE1", "H", 0.3412),
                  ("CE2", "CN", 0.1380), ("CZ2", "CA", -0.2601),
                  ("HZ2", "HA", 0.1572), ("CH2", "CA", -0.1134),
                  ("HH2", "HA", 0.1417), ("CZ3", "CA", -0.1972),
                  ("HZ3", "HA", 0.1447), ("CE3", "CA", -0.2387),
                  ("HE3", "HA", 0.1700), ("CD2", "CB", 0.1243)],
                 -0.0275, 0.1123,
                 extra_bonds=[("CG", "CD1"), ("CD1", "NE1"), ("NE1", "CE2"),
                              ("CE2", "CD2"), ("CD2", "CG"), ("CE2", "CZ2"),
                              ("CZ2", "CH2"), ("CH2", "CZ3"), ("CZ3", "CE3"),
                              ("CE3", "CD2")])

# HIS: neutral NE2-protonated tautomer (HIE), the Amber default.
_T["HIS"] = _res([("CB", "CT", -0.0074), ("HB2", "HC", 0.0367),
                  ("HB3", "HC", 0.0367), ("CG", "CC", 0.1868),
                  ("ND1", "NB", -0.5432), ("CE1", "CR", 0.1635),
                  ("HE1", "H5", 0.1435), ("NE2", "NA", -0.2795),
                  ("HE2", "H", 0.3339), ("CD2", "CW", -0.2207),
                  ("HD2", "H4", 0.1862)], -0.0581, 0.1360,
                 extra_bonds=[("CG", "ND1"), ("ND1", "CE1"), ("CE1", "NE2"),
                              ("NE2", "CD2"), ("CD2", "CG")])

_T["SER"] = _res([("CB", "CT", 0.2117), ("HB2", "H1", 0.0352),
                  ("HB3", "H1", 0.0352), ("OG", "OH", -0.6546),
                  ("HG", "HO", 0.4275)], -0.0249, 0.0843)

_T["THR"] = _res([("CB", "CT", 0.3654), ("HB", "H1", 0.0043),
                  ("CG2", "CT", -0.2438), ("HG21", "HC", 0.0642),
                  ("HG22", "HC", 0.0642), ("HG23", "HC", 0.0642),
                  ("OG1", "OH", -0.6761), ("HG1", "HO", 0.4102)],
                 -0.0389, 0.1007)

_T["CYS"] = _res([("CB", "CT", -0.1231), ("HB2", "H1", 0.1112),
                  ("HB3", "H1", 0.1112), ("SG", "SH", -0.3119),
                  ("HG", "HS", 0.1933)], 0.0213, 0.1124)

_T["MET"] = _res([("CB", "CT", 0.0342), ("HB2", "HC", 0.0241),
                  ("HB3", "HC", 0.0241), ("CG", "CT", 0.0018),
                  ("HG2", "H1", 0.0440), ("HG3", "H1", 0.0440),
                  ("SD", "S", -0.2737), ("CE", "CT", -0.0536),
                  ("HE1", "H1", 0.0684), ("HE2", "H1", 0.0684),
                  ("HE3", "H1", 0.0684)], -0.0237, 0.0880)

_T["ASN"] = _res([("CB", "CT", -0.2041), ("HB2", "HC", 0.0797),
                  ("HB3", "HC", 0.0797), ("CG", "C", 0.7130),
                  ("OD1", "O", -0.5931), ("ND2", "N", -0.9191),
                  ("HD21", "H", 0.4196), ("HD22", "H", 0.4196)],
                 0.0143, 0.1048)

_T["GLN"] = _res([("CB", "CT", -0.0036), ("HB2", "HC", 0.0171),
                  ("HB3", "HC", 0.0171), ("CG", "CT", -0.0645),
                  ("HG2", "HC", 0.0352), ("HG3", "HC", 0.0352),
                  ("CD", "C", 0.6951), ("OE1", "O", -0.6086),
                  ("NE2", "N", -0.9407), ("HE21", "H", 0.4251),
                  ("HE22", "H", 0.4251)], -0.0031, 0.0850)

_T["ASP"] = _res([("CB", "CT", -0.0303), ("HB2", "HC", -0.0122),
                  ("HB3", "HC", -0.0122), ("CG", "C", 0.7994),
                  ("OD1", "O2", -0.8014), ("OD2", "O2", -0.8014)],
                 0.0381, 0.0880,
                 bb_n=[("N", "N", -0.5163), ("H", "H", 0.2936)],
                 bb_end=[("C", "C", 0.5366), ("O", "O", -0.5819)])

_T["GLU"] = _res([("CB", "CT", 0.0560), ("HB2", "HC", -0.0173),
                  ("HB3", "HC", -0.0173), ("CG", "CT", 0.0136),
                  ("HG2", "HC", -0.0425), ("HG3", "HC", -0.0425),
                  ("CD", "C", 0.8054), ("OE1", "O2", -0.8188),
                  ("OE2", "O2", -0.8188)], 0.0397, 0.1105,
                 bb_n=[("N", "N", -0.5163), ("H", "H", 0.2936)],
                 bb_end=[("C", "C", 0.5366), ("O", "O", -0.5819)])

_T["LYS"] = _res([("CB", "CT", -0.0094), ("HB2", "HC", 0.0362),
                  ("HB3", "HC", 0.0362), ("CG", "CT", 0.0187),
                  ("HG2", "HC", 0.0103), ("HG3", "HC", 0.0103),
                  ("CD", "CT", -0.0479), ("HD2", "HC", 0.0621),
                  ("HD3", "HC", 0.0621), ("CE", "CT", -0.0143),
                  ("HE2", "HP", 0.1135), ("HE3", "HP", 0.1135),
                  ("NZ", "N3", -0.3854), ("HZ1", "H", 0.3400),
                  ("HZ2", "H", 0.3400), ("HZ3", "H", 0.3400)],
                 -0.2400, 0.1426,
                 bb_n=[("N", "N", -0.3479), ("H", "H", 0.2747)],
                 bb_end=[("C", "C", 0.7341), ("O", "O", -0.5894)])

_T["ARG"] = _res([("CB", "CT", -0.0007), ("HB2", "HC", 0.0327),
                  ("HB3", "HC", 0.0327), ("CG", "CT", 0.0390),
                  ("HG2", "HC", 0.0285), ("HG3", "HC", 0.0285),
                  ("CD", "CT", 0.0486), ("HD2", "H1", 0.0687),
                  ("HD3", "H1", 0.0687), ("NE", "N2", -0.5295),
                  ("HE", "H", 0.3456), ("CZ", "CA", 0.8076),
                  ("NH1", "N2", -0.8627), ("HH11", "H", 0.4478),
                  ("HH12", "H", 0.4478), ("NH2", "N2", -0.8627),
                  ("HH21", "H", 0.4478), ("HH22", "H", 0.4478)],
                 -0.2637, 0.1560,
                 bb_n=[("N", "N", -0.3479), ("H", "H", 0.2747)],
                 bb_end=[("C", "C", 0.7341), ("O", "O", -0.5894)])


def _template_bonds(atoms, extra):
    """Implicit bonds: each H bonds to the preceding heavy atom; heavy-atom
    chain follows standard residue topology via the name map below."""
    name_i = {a[0]: i for i, a in enumerate(atoms)}
    bonds = set()
    # each hydrogen bonds to the nearest PRECEDING heavy atom (template
    # atom ordering lists every H right after its parent)
    last_heavy = None
    for nm, ty, _q in atoms:
        if nm.startswith("H"):
            if last_heavy is not None:
                bonds.add(tuple(sorted((name_i[nm], name_i[last_heavy]))))
        else:
            last_heavy = nm
    # backbone + CB chain
    std = [("N", "CA"), ("CA", "C"), ("C", "O"), ("CA", "CB"),
           ("CB", "CG"), ("CB", "CG1"), ("CB", "CG2"), ("CB", "OG"),
           ("CB", "OG1"), ("CB", "SG"), ("CG", "CD"), ("CG", "CD1"),
           ("CG", "CD2"), ("CG", "SD"), ("CG", "OD1"), ("CG", "ND2"),
           ("CG1", "CD1"), ("SD", "CE"), ("CD", "CE"), ("CD", "OE1"),
           ("CD", "NE2"), ("CD", "NE"), ("CD", "OE2"), ("CE", "NZ"),
           ("NE", "CZ"), ("CZ", "NH1"), ("CZ", "NH2"),
           ("CG", "OD2")]
    for a, b in std:
        if a in name_i and b in name_i:
            bonds.add(tuple(sorted((name_i[a], name_i[b]))))
    for a, b in extra:
        bonds.add(tuple(sorted((name_i[a], name_i[b]))))
    return sorted(bonds)


def _normalize(atoms, target_net):
    """Snap the residue net charge to the target integer by spreading the
    residual over heavy atoms (guards against transcription drift)."""
    net = sum(q for _, _, q in atoms)
    resid = target_net - net
    heavy = [i for i, (_, t, _) in enumerate(atoms)
             if not t.startswith("H")]
    adj = resid / max(len(heavy), 1)
    out = []
    for i, (nm, ty, q) in enumerate(atoms):
        out.append((nm, ty, q + (adj if i in heavy else 0.0)))
    return out


_NET = {"ASP": -1, "GLU": -1, "LYS": 1, "ARG": 1}

RESIDUE_TEMPLATES = {}
for _name, (_atoms, _extra) in _T.items():
    _atoms = _normalize(_atoms, float(_NET.get(_name, 0)))
    RESIDUE_TEMPLATES[_name] = {
        "atoms": _atoms,
        "bonds": _template_bonds(_atoms, _extra),
    }

# common alternate residue names
RESIDUE_ALIASES = {
    "HIE": "HIS", "HID": "HIS", "HIP": "HIS", "HSD": "HIS", "HSE": "HIS",
    "CYX": "CYS", "CYM": "CYS", "ASH": "ASP", "GLH": "GLU", "LYN": "LYS",
    "MSE": "MET",
}

# Terminal patches --------------------------------------------------------
# N-terminal: replace (N, H) by (N3, H1/H2/H3 at +), Amber NALA-lineage.
NTERM_PATCH = {
    "N_type": "N3",
    "H_names": ("H1", "H2", "H3"),
    "H_type": "H",
    "H_charge": 0.1997,
    "N_charge": 0.1414,
}
# C-terminal: replace (C, O) by (C, O/OXT as O2), Amber CALA-lineage.
CTERM_PATCH = {
    "C_charge": 0.7731,
    "O_type": "O2",
    "O_charge": -0.8055,
}
