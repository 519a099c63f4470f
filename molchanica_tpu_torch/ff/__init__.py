"""Force-field front end on the host: Amber parameter parsing, GAFF2
typing, Gasteiger charges and assignment into a MolSpec (numpy copies of
molchanica_tpu.ff's amber_dat, typing_gaff, charges and params)."""
from .amber_dat import parse_dat, parse_frcmod  # noqa: F401
from .params import FfParamSet, ForceFieldParams, merge_params  # noqa: F401
