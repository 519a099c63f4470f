"""Trajectory/structure analysis: H-bonds (port of molchanica_tpu.analysis)."""
from .hbonds import HydrogenBond, find_hydrogen_bonds  # noqa: F401
