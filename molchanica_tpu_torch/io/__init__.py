"""Structure and trajectory files: readers, writers and the
format-dispatched `open_file` (port of molchanica_tpu.io).

Structures: SDF, MOL2, PDB, XYZ, GRO, mmCIF. Trajectories: DCD, TRR, XTC
and multi-frame GRO. Amber input: prmtop (a parameterized MolSpec) and
inpcrd. All host-side numpy; each writer gives the JAX package's bytes.
"""
from .dcd import read_dcd, write_dcd                      # noqa: F401
from .gro import read_gro, write_gro, write_gro_trajectory  # noqa: F401
from .mmcif import read_mmcif, write_mmcif                # noqa: F401
from .mol2 import read_mol2, write_mol2                   # noqa: F401
from .pdb import read_pdb, write_pdb                      # noqa: F401
from .prmtop import read_inpcrd, read_prmtop              # noqa: F401
from .sdf import read_sdf, write_sdf                      # noqa: F401
from .trr import TrrFrame, read_trr, write_trr            # noqa: F401
from .xtc import XtcFrame, read_xtc, write_xtc            # noqa: F401
from .xyz import read_xyz, write_xyz                      # noqa: F401


def open_file(path):
    """Read a structure file, the reader chosen by its extension (the
    reference's State::open_file): .sdf/.mol/.mdl, .mol2, .pdb/.ent, .xyz,
    .gro (a (molecule, box) pair), .cif/.mmcif. Any other raises
    ValueError."""
    p = str(path).lower()
    if p.endswith((".sdf", ".mol", ".mdl")):
        return read_sdf(path)
    if p.endswith(".mol2"):
        return read_mol2(path)
    if p.endswith((".pdb", ".ent")):
        return read_pdb(path)
    if p.endswith(".xyz"):
        return read_xyz(path)
    if p.endswith(".gro"):
        return read_gro(path)
    if p.endswith(".cif") or p.endswith(".mmcif"):
        return read_mmcif(path)
    raise ValueError(f"unrecognized structure format: {path}")
