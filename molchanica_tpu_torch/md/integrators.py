"""Velocity-Verlet and Langevin-middle steps (port of the part of
molchanica_tpu.md.integrators that FastSim's slice runs; CSVR and leapfrog
are not ported yet).

Constraints are injected as two callables:
  constrain_positions(x_new, x_ref) -> x_new'
  constrain_velocities(v, x)        -> v'
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..constants import ACCEL_FACTOR, KB


def _accel(forces, masses, dof_mask):
    a = forces * (ACCEL_FACTOR / torch.clamp_min(masses, 1e-6))[:, None]
    return a * dof_mask[:, None]


def make_integrator_step(
    force_fn,                 # x -> (F, (E, terms))
    masses,
    dof_mask,
    kind: str,
    dt: float,
    temp_target: float,
    thermostat_tau: Optional[float],
    gamma: float,
    constrain_positions: Optional[Callable] = None,
    constrain_velocities: Optional[Callable] = None,
    force_cap: Optional[float] = None,
    cadence: str = "light",
):
    """Build one_step(x, v, f, noise=None) -> (x, v, f, E, terms).

    `f` is carried across steps, so each step does one force evaluation.
    `noise` (langevin_middle): pre-drawn standard normals of v.shape, one
    [k, N, 3] draw per rebuild period made by the caller.
    """
    cp = constrain_positions or (lambda x_new, x_ref: x_new)
    cv = constrain_velocities or (lambda v, x: v)
    dm = dof_mask[:, None]

    def eval_forces(x):
        f, (e, terms) = force_fn(x)
        if force_cap is not None:
            # per-atom force clamp, an equilibration aid for clashy starts
            norm = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True))
            f = f * torch.clamp_max(force_cap / torch.clamp_min(norm, 1e-9),
                                    1.0)
        return f, e, terms

    # constrained drift: projection plus the velocity update implied by
    # the constraint displacement, v += (x_c - x_u) / h
    def drift(x, v, h):
        xu = x + h * v * dm
        xc = cp(xu, x)
        return xc, v + (xc - xu) / h

    if kind == "verlet_velocity":
        if thermostat_tau is not None:
            raise NotImplementedError("CSVR is not ported yet")

        def one_step(x, v, f, noise=None):
            v_half = v + 0.5 * dt * _accel(f, masses, dof_mask)
            x_new, v_half = drift(x, v_half, dt)
            f_new, e, terms = eval_forces(x_new)
            v_new = v_half + 0.5 * dt * _accel(f_new, masses, dof_mask)
            return x_new, cv(v_new, x_new), f_new, e, terms

    elif kind == "langevin_middle":
        # BAOAB (OpenMM LangevinMiddle). "light": RATTLE once after the
        # kick, SHAKE once (with velocity feedback over the full dt) after
        # the last half-drift. "strict" (g-BAOAB): a projection after every
        # substep.
        c1 = math.exp(-gamma * dt)
        sigma = torch.sqrt(
            KB * temp_target * ACCEL_FACTOR
            / torch.clamp_min(masses, 1e-6) * (1.0 - c1 * c1))[:, None]

        def kick(v, noise):
            if noise is None:
                noise = torch.randn_like(v)
            return noise * sigma

        if cadence == "light":
            def one_step(x, v, f, noise=None):
                v1 = cv(v + dt * _accel(f, masses, dof_mask), x)  # B+RATTLE
                x1 = x + (0.5 * dt) * v1 * dm                      # A
                v2 = (c1 * v1 + kick(v, noise)) * dm               # O
                xu = x1 + (0.5 * dt) * v2 * dm                     # A
                x2 = cp(xu, x)
                v2 = v2 + (x2 - xu) * (1.0 / dt)
                f_new, e, terms = eval_forces(x2)
                return x2, v2, f_new, e, terms
        elif cadence == "strict":
            def one_step(x, v, f, noise=None):
                v1 = v + dt * _accel(f, masses, dof_mask)          # B
                x1, v1 = drift(x, v1, 0.5 * dt)                    # A
                v1 = cv(v1, x1)
                v2 = cv((c1 * v1 + kick(v, noise)) * dm, x1)       # O
                x2, v2 = drift(x1, v2, 0.5 * dt)                   # A
                v2 = cv(v2, x2)
                f_new, e, terms = eval_forces(x2)
                return x2, v2, f_new, e, terms
        else:
            raise ValueError(f"unknown Langevin cadence: {cadence}")

    else:
        raise ValueError(f"integrator kind not ported: {kind}")

    return one_step
