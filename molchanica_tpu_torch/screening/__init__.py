"""Ligand screening: pharmacophore models + batched directory screening
(port of molchanica_tpu.screening)."""
from .pharmacophore import (  # noqa: F401
    Pharmacophore,
    PharmacophoreFeat,
    PharmacophoreFeatType,
    auto_pharmacophore,
)
from .screen import screen_ligs  # noqa: F401
