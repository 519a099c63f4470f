"""Integrators: leapfrog, velocity-Verlet, Langevin-middle; the CSVR
thermostat (port of molchanica_tpu.md.integrators).

Constraints are injected as two callables:
  constrain_positions(x_new, x_ref) -> x_new'
  constrain_velocities(v, x)        -> v'

Random numbers come from the caller's torch.Generator: Langevin noise and
the CSVR draws are made outside the step and passed in, so a test can feed
the exact numbers another engine drew.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..constants import ACCEL_FACTOR, KB
from .state import kinetic_energy


def _accel(forces, masses, dof_mask):
    a = forces * (ACCEL_FACTOR / torch.clamp_min(masses, 1e-6))[:, None]
    return a * dof_mask[:, None]


def csvr_ndof(dof_mask, n_constraints=0) -> int:
    """Degrees of freedom the CSVR thermostat sees: 3 N_dof - constraints
    - 3 (COM motion removed)."""
    return int(round(3.0 * float(dof_mask.sum()))) - int(n_constraints) - 3


def csvr_draws(generator, ndof: int, dtype, device):
    """The two random numbers of one CSVR step from `generator`: R1 ~ N(0,
    1) and S ~ chi^2 with ndof - 1 degrees of freedom, the sum of squares of
    ndof - 1 standard normals (one draw of ndof normals, on the device)."""
    z = torch.randn((max(ndof, 1),), generator=generator, dtype=dtype,
                    device=device)
    return z[0], torch.sum(z[1:] * z[1:])


def csvr_rescale(velocities, masses, dof_mask, temp_target, dt, tau,
                 n_constraints, r1, s):
    """Bussi CSVR stochastic velocity rescaling with the draws (r1, s) of
    `csvr_draws`; returns the scaled velocities. With a leading replica
    axis (velocities [R, N, 3], r1 and s [R]) each replica is rescaled by
    its own kinetic energy.

    alpha^2 = c + (1-c) (KEbar/(ndof KE)) (R1^2 + S)
              + 2 R1 sqrt(c (1-c) KEbar/(ndof KE)),
    c = exp(-dt/tau), KEbar = ndof kB T / 2."""
    ndof = 3.0 * torch.sum(dof_mask) - n_constraints - 3.0
    ke = torch.clamp_min(kinetic_energy(velocities, masses, dof_mask), 1e-10)
    ke_bar = 0.5 * ndof * KB * temp_target
    c = math.exp(-dt / tau)
    ratio = ke_bar / (ndof * ke)
    alpha2 = c + (1.0 - c) * ratio * (r1 * r1 + s) \
        + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * ratio)
    alpha = torch.sqrt(torch.clamp_min(alpha2, 1e-12))
    return velocities * alpha[..., None, None]


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
    n_constraints: int = 0,
):
    """Build one_step(x, v, f, noise=None) -> (x, v, f, E, terms).

    `f` is carried across steps, so each step does one force evaluation.
    `noise`: for langevin_middle, standard normals of v.shape drawn by the
    caller (None draws them from torch's default generator); for
    leapfrog and velocity-Verlet with a thermostat tau, the CSVR draws
    (r1, s) of `csvr_draws`.
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

    def thermostat(v, draws):
        if thermostat_tau is None:
            return v
        return csvr_rescale(v, masses, dof_mask, temp_target, dt,
                            thermostat_tau, n_constraints, *draws)

    if kind == "verlet_velocity":
        def one_step(x, v, f, noise=None):
            v_half = v + 0.5 * dt * _accel(f, masses, dof_mask)
            x_new, v_half = drift(x, v_half, dt)
            f_new, e, terms = eval_forces(x_new)
            v_new = v_half + 0.5 * dt * _accel(f_new, masses, dof_mask)
            return x_new, thermostat(cv(v_new, x_new), noise), f_new, e, \
                terms

    elif kind == "leapfrog":
        def one_step(x, v, f, noise=None):
            # v is v(t - dt/2): kick to v(t + dt/2), thermostat, drift
            v_new = thermostat(v + dt * _accel(f, masses, dof_mask), noise)
            x_new, v_new = drift(x, v_new, dt)
            v_new = cv(v_new, x_new)
            f_new, e, terms = eval_forces(x_new)
            return x_new, v_new, f_new, e, terms

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
        raise ValueError(f"unknown integrator kind: {kind}")

    return one_step
