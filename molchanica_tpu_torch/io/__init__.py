"""Structure file readers and writers: PDB and SDF (copies of
molchanica_tpu.io.pdb and .sdf). The other formats and the format-dispatched
open_file are not ported yet."""
from .pdb import read_pdb, write_pdb            # noqa: F401
from .sdf import read_sdf, write_sdf            # noqa: F401
