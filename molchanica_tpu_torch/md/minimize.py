"""Energy minimization by FIRE (port of molchanica_tpu.md.minimize), as one
host loop over single FIRE iterations: MdSim's initial relaxation
(cfg.max_init_relaxation_iters). The iteration's bookkeeping (dt, alpha,
the count of downhill steps) stays in tensors on the device, so the loop
makes no host sync.
"""
from __future__ import annotations

import torch


def fire_minimize(force_fn, x0, box, couple, dof_mask, n_steps: int = 200,
                  constrain_positions=None, dt_start=1e-3, dt_max=1e-2,
                  max_disp=0.1, f_inc=1.1, f_dec=0.5, alpha_start=0.1,
                  f_alpha=0.99, n_min=5, energies=None, best=None):
    """FIRE (fast inertial relaxation engine) over n_steps force
    evaluations. Returns (x_min, E) with E the energy of the last
    evaluation, taken before the last move (the reference's
    fire_minimize_hostloop). `constrain_positions(x_new, x_ref)` runs
    after every move, so rigid waters and constrained H stay on their
    manifold. A list `energies` receives each evaluation's energy; a
    dict `best` receives "x" and "e", the evaluated state of lowest
    energy (kept on the device, no host sync)."""
    dm = dof_mask[:, None]
    cp = constrain_positions or (lambda x_new, x_ref: x_new)
    x = x0
    v = torch.zeros_like(x0)
    dt = torch.tensor(dt_start, dtype=x0.dtype, device=x0.device)
    alpha = torch.tensor(alpha_start, dtype=x0.dtype, device=x0.device)
    n_pos = torch.zeros((), dtype=torch.int64, device=x0.device)
    e = torch.zeros((), dtype=x0.dtype, device=x0.device)
    x_best, e_best = x0, torch.full_like(e, float("inf"))
    for _ in range(n_steps):
        f, (e, _) = force_fn(x, box, couple)
        if energies is not None:
            energies.append(e)
        if best is not None:
            better = e < e_best
            x_best = torch.where(better, x, x_best)
            e_best = torch.where(better, e, e_best)
        f = f * dm
        p = torch.sum(f * v)
        f_norm = torch.sqrt(torch.sum(f * f)) + 1e-12
        v_norm = torch.sqrt(torch.sum(v * v))
        v = (1.0 - alpha) * v + alpha * f / f_norm * v_norm
        uphill = p <= 0.0
        v = torch.where(uphill, torch.zeros_like(v), v)
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        grow = ~uphill & (n_pos > n_min)
        dt = torch.where(grow, torch.clamp_max(dt * f_inc, dt_max),
                         torch.where(uphill, dt * f_dec, dt))
        alpha = torch.where(grow, alpha * f_alpha,
                            torch.where(uphill,
                                        torch.full_like(alpha, alpha_start),
                                        alpha))
        v = v + dt * f
        dx = dt * v
        # clamp the per-atom displacement
        dx_norm = torch.sqrt(torch.sum(dx * dx, dim=-1, keepdim=True)) \
            + 1e-12
        dx = dx * torch.clamp_max(max_disp / dx_norm, 1.0)
        x = cp(x + dx * dm, x)
    if best is not None:
        best.update(x=x_best, e=e_best)
    return x, e
