"""Alchemical free-energy machinery: lambda windows + thermodynamic
integration (copy of molchanica_tpu.md.alchemical; numpy only).

Reference surface (dynamics::alchemical, SURVEY.md §2.1): `LambdaWindow`,
`collect_window(lambda, &snapshots)`, `free_energy_ti_with_sem`,
`mean_coupled_interaction_kcal`, `AlchemicalError`. Convention: lambda in
[0, 1], 0 = fully coupled; dH/dlambda recorded per snapshot.

FastSim.dhdl() samples dH/dlambda per window (properties/water_sol.py);
this module turns per-window sample sets into a TI estimate with a
block-averaged standard error.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


class AlchemicalError(RuntimeError):
    pass


@dataclass
class LambdaWindow:
    lam: float
    dhdl_samples: np.ndarray          # [n_snapshots]

    @property
    def mean(self) -> float:
        return float(np.mean(self.dhdl_samples))

    def sem(self, n_blocks: int = 5) -> float:
        """Block-averaged standard error (handles autocorrelation crudely)."""
        x = np.asarray(self.dhdl_samples, np.float64)
        if len(x) < 2:
            return float("inf")
        nb = min(n_blocks, len(x))
        blocks = np.array_split(x, nb)
        means = np.asarray([b.mean() for b in blocks])
        return float(means.std(ddof=1) / np.sqrt(len(means)))


def collect_window(lam: float, snapshots: Sequence) -> LambdaWindow:
    """Build a LambdaWindow from engine snapshots (reference
    collect_window(lambda, &snapshots))."""
    samples = [s.dhdl for s in snapshots if s.dhdl is not None]
    if not samples:
        raise AlchemicalError(
            f"no dH/dlambda samples recorded for lambda={lam}")
    return LambdaWindow(lam=lam, dhdl_samples=np.asarray(samples))


def free_energy_ti_with_sem(windows: Sequence[LambdaWindow]):
    """Trapezoidal TI over lambda: (dG, sem). dG = integral dH/dl dl from
    lambda=0 (coupled) to 1 (decoupled) — the decoupling free energy."""
    if len(windows) < 2:
        raise AlchemicalError("TI needs at least 2 lambda windows")
    ws = sorted(windows, key=lambda w: w.lam)
    lams = np.asarray([w.lam for w in ws])
    means = np.asarray([w.mean for w in ws])
    sems = np.asarray([w.sem() for w in ws])
    dg = float(np.trapezoid(means, lams))
    # trapezoid weights for error propagation
    wts = np.zeros(len(ws))
    for i in range(len(ws) - 1):
        h = lams[i + 1] - lams[i]
        wts[i] += h / 2
        wts[i + 1] += h / 2
    sem = float(np.sqrt(np.sum((wts * sems) ** 2)))
    return dg, sem


def mean_coupled_interaction_kcal(snapshots: Sequence) -> float:
    """Mean solute-environment interaction energy at full coupling —
    the reference's descriptor companion to TI (SURVEY §2.1). Uses the
    nonbonded energy gap recorded in snapshots when available."""
    vals = [s.energy_data.energy_potential_nonbonded
            for s in snapshots if s.energy_data is not None]
    if not vals:
        raise AlchemicalError("no energy data in snapshots")
    return float(np.mean(vals))


# The reference hydration-TI protocol constants
# (src/properties/water_sol.rs:50-55)
HYDRATION_LAMBDAS: List[float] = [
    0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0]
HYDRATION_EQUIL_STEPS = 5_000
HYDRATION_PROD_STEPS = 20_000
HYDRATION_BOX_SIDE = 35.0
