"""Spatial domain decomposition: one simulation split into x-slabs over the
processes of a torch.distributed group (port of
molchanica_tpu.parallel.spatial).

Each rank owns the atoms of its slab; short-range forces need only the
neighbouring slabs' atoms, exchanged over the ring every force call.
With a PME grid, the reciprocal energy is evaluated on every rank from
the gathered positions and charges (a replicated grid), and each rank
takes its own rows of its gradient. This is the communication and
correctness prototype: the direct space is a masked dense local x
(local + halo) pair sum, not a kernel.

The JAX reference divides its recip gradient by the number of devices:
there, autodiff through all_gather sums the identical replicated
cotangent over the devices. Here the gradient is taken of the one
replicated energy with respect to the gathered positions, so its local
rows are dE/dx as they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import ACCEL_FACTOR, COULOMB_CONST, KB
from ..device import resolve_device
from .comm import Comm


def partition_slabs(x, box, n_dev: int, cap: int = None):
    """Host-side: bin atoms into x-slabs -> (x_sh [n_dev, cap, 3], mask
    [n_dev, cap], owner [n_dev, cap] original indices; -1 pad). cap
    defaults to the largest slab count with 25% headroom, rounded up to
    a multiple of 8."""
    x = np.asarray(x)
    lx = float(box[0])
    w = lx / n_dev
    xw = x - np.floor(x / np.asarray(box)) * np.asarray(box)
    slab = np.minimum((xw[:, 0] / w).astype(int), n_dev - 1)
    counts = np.bincount(slab, minlength=n_dev)
    if cap is None:
        cap = int(-(-int(counts.max() * 1.25 + 8) // 8) * 8)
    if counts.max() > cap:
        raise ValueError(f"slab overflow: {counts.max()} > {cap}")
    xs = np.zeros((n_dev, cap, 3), np.float32)
    mask = np.zeros((n_dev, cap), np.float32)
    owner = np.full((n_dev, cap), -1, np.int64)
    for dev in range(n_dev):
        ids = np.where(slab == dev)[0]
        xs[dev, :len(ids)] = xw[ids]
        mask[dev, :len(ids)] = 1.0
        owner[dev, :len(ids)] = ids
    return xs, mask, owner


def _pair_energy_force(xi, mi, xj, mj, qi, qj, si, sj, ei, ej, box, rc,
                       beta=None):
    """Masked dense LJ + Coulomb between an i block [ci, 3] and a j block
    [cj, 3]: (E half counted, F_i [ci, 3]). beta None: plain cutoff
    Coulomb; beta a float: erfc(beta r)/r direct-space Ewald."""
    d = xi[:, None, :] - xj[None, :, :]
    d = d - box * torch.round(d / box)
    r2 = torch.sum(d * d, -1)
    ok = ((r2 < rc * rc) & (r2 > 1e-9) & (mi[:, None] > 0)
          & (mj[None, :] > 0))
    r2s = torch.clamp_min(r2, 0.25)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    sig = si[:, None] + sj[None, :]
    eps4 = ei[:, None] * ej[None, :]
    s2 = torch.clamp_max(sig * sig * inv_r2, 6.25)
    s6 = s2 * s2 * s2
    e_lj = eps4 * (s6 * s6 - s6)
    kqq = qi[:, None] * qj[None, :]
    if beta is None:
        e_c = kqq * inv_r
        dc = -0.5 * kqq * inv_r2 * inv_r
    else:
        r = r2s * inv_r
        erfc_v = torch.special.erfc(beta * r)
        e_c = kqq * erfc_v * inv_r
        dc = -kqq * inv_r2 * (0.5 * erfc_v * inv_r + beta / math.sqrt(
            math.pi) * torch.exp(-(beta * r) ** 2))
    de = eps4 * (3.0 * s6 - 6.0 * s6 * s6) * inv_r2 + dc
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    coeff = torch.where(ok, de, zero)
    f_i = -torch.sum((2.0 * coeff)[:, :, None] * d, 1)
    e = 0.5 * torch.sum(torch.where(ok, e_lj + e_c, zero))
    return e, f_i


def make_spatial_force_fn(group, box, rc: float, halo_depth: int = 1,
                          beta=None, pme_grid=None, device=None):
    """force(x, m, q, s, e) -> (E total, F [cap, 3]) on this rank of
    `group`, for its slab (x [cap, 3], mask, q, sigma/2, 2 sqrt(eps)):
    forces from its own slab plus halo_depth slabs on each side (the slab
    width must be >= rc / halo_depth), received from ranks d -+ k and
    summed in the reference's order (side +1, then side -1). With beta
    and pme_grid the electrostatics are smooth-PME Ewald: erfc(beta r)
    direct within the halo, the reciprocal sum on a replicated grid, q in
    electron units, the Ewald self energy included. No intramolecular
    exclusions: atomic fluids. `device` None means the CUDA card, which
    must be there."""
    comm = Comm(group, device)
    d, n = comm.rank, comm.size
    boxt = torch.as_tensor(np.asarray(box), dtype=torch.float32,
                           device=comm.device)
    recip = None
    if pme_grid is not None:
        if beta is None:
            raise ValueError("pme_grid requires beta")
        from ..ops.pme2 import make_pme2_recip_fn
        recip = make_pme2_recip_fn(tuple(pme_grid), float(beta),
                                   device=comm.device)
    sqrt_kc = float(np.sqrt(COULOMB_CONST)) if recip is not None else 1.0
    self_c = (float(beta) / math.sqrt(math.pi) * COULOMB_CONST
              if recip is not None else 0.0)

    def force(x, m, q, s, e):
        qd = q * sqrt_kc
        etot, f = _pair_energy_force(x, m, x, m, qd, qd, s, s, e, e, boxt,
                                     rc, beta=beta)
        pack = torch.cat([x, torch.stack([m, qd, s, e], 1)], 1)
        sends, recvs = [], []
        for k in range(1, halo_depth + 1):
            sends += [((d + k) % n, pack), ((d - k) % n, pack)]
            recvs += [((d - k) % n, pack), ((d + k) % n, pack)]
        got = comm.exchange(sends, recvs)
        # side +1 receives slab d - k, side -1 slab d + k; each cross-slab
        # pair is half counted on both owners
        for p in got[0::2] + got[1::2]:
            eh, fh = _pair_energy_force(x, m, p[:, :3], p[:, 3], qd, p[:, 4],
                                        s, p[:, 5], e, p[:, 6], boxt, rc,
                                        beta=beta)
            etot = etot + eh
            f = f + fh
        etot = comm.all_reduce(etot)
        if recip is not None:
            q_real = q * (m > 0)
            x_all = comm.all_gather(x)
            q_all = comm.all_gather(q_real)
            with torch.enable_grad():
                xa = x_all.detach().requires_grad_(True)
                er = recip(xa, q_all, boxt)
                (g,) = torch.autograd.grad(er, xa)
            e_self = comm.all_reduce(-self_c * torch.sum(q_real * q_real))
            etot = etot + er.detach() + e_self
            f = f - g[d * x.shape[0]:(d + 1) * x.shape[0]]
        return etot, f

    return force


def spatial_reference_force(x, mask, q, sig, eps, box, rc):
    """Single-device dense reference with the same pair math."""
    boxt = torch.as_tensor(np.asarray(box), dtype=x.dtype, device=x.device)
    return _pair_energy_force(x, mask, x, mask, q, q, sig, sig, eps, eps,
                              boxt, rc)


def make_spatial_step_fn(group, box, rc: float, dt: float, gamma: float,
                         temp_target: float, beta=None, pme_grid=None,
                         device=None):
    """Langevin-middle MD chunk of one simulation decomposed over `group`,
    halo forces exchanged every step: chunk(x, v, m, q, s, e, mass,
    generator, k) -> (x, v, ke total) for this rank's slab. The noise
    comes from the rank's own generator. `device` None means the CUDA
    card."""
    comm = Comm(group, device)
    force = make_spatial_force_fn(group, box, rc, 1, beta, pme_grid, device)
    c1 = math.exp(-gamma * dt)

    def chunk(x, v, m, q, s, e, mass, generator, k_steps):
        inv_mass = torch.where(mass > 0, 1.0 / torch.clamp_min(mass, 1e-6),
                               torch.zeros_like(mass))
        dm = (m > 0).to(x.dtype)[:, None]
        sigma = torch.sqrt(KB * temp_target * ACCEL_FACTOR * inv_mass
                           * (1.0 - c1 * c1))[:, None]
        _e, f = force(x, m, q, s, e)
        for _ in range(k_steps):
            a = f * (ACCEL_FACTOR * inv_mass)[:, None] * dm
            v1 = v + dt * a                                   # B
            x1 = x + 0.5 * dt * v1 * dm                       # A
            noise = torch.randn(v.shape, generator=generator,
                                dtype=v.dtype, device=v.device) * sigma
            v = (c1 * v1 + noise) * dm                        # O
            x = x1 + 0.5 * dt * v * dm                        # A
            _e, f = force(x, m, q, s, e)
        ke = 0.5 * torch.sum(mass * dm[:, 0] * torch.sum(v * v, -1)) \
            / ACCEL_FACTOR
        return x, v, comm.all_reduce(ke)

    return chunk


def spatial_md_run(x, v, masses, q, sig, eps, box, group, rc: float,
                   dt: float, n_steps: int, rebuild_every: int = 10,
                   gamma: float = 2.0, temp_target: float = 300.0,
                   seed: int = 0, beta=None, pme_grid=None, device=None):
    """Run one simulation decomposed over `group`, called on every rank
    with the same arguments. The atoms are re-partitioned into x-slabs
    every `rebuild_every` steps (replicated on every rank; atoms drift
    between slabs only as far as the slab width exceeds rc), each rank
    steps its slab, and the slabs are gathered back. The noise of rank r
    comes from a generator seeded from (seed, r). Returns (x, v, ke
    history) in the original atom order, on every rank, on `device`
    (None: the CUDA card)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    n_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    step = make_spatial_step_fn(group, box, rc, dt, gamma, temp_target,
                                beta=beta, pme_grid=pme_grid, device=dev)
    comm = Comm(group, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence([seed, rank])
                        .generate_state(1)[0]))
    x = np.asarray(x, np.float32).copy()
    v = np.asarray(v, np.float32).copy()
    kes = []
    done = 0
    while done < n_steps:
        k = min(rebuild_every, n_steps - done)
        xs, m_sh, owner = partition_slabs(x, box, n_dev)
        ids = owner[rank][owner[rank] >= 0]

        def mine(a, width=None):
            shape = (xs.shape[1],) + (() if width is None else (width,))
            out = np.zeros(shape, np.float32)
            out[:len(ids)] = a[ids]
            return torch.as_tensor(out, device=dev)

        x2, v2, ke = step(torch.as_tensor(xs[rank], device=dev),
                          mine(v, 3), torch.as_tensor(m_sh[rank], device=dev),
                          mine(q), mine(sig), mine(eps), mine(masses), gen, k)
        xa = comm.all_gather(x2).cpu().numpy().reshape(n_dev, -1, 3)
        va = comm.all_gather(v2).cpu().numpy().reshape(n_dev, -1, 3)
        for dd in range(n_dev):
            own = owner[dd][owner[dd] >= 0]
            x[own] = xa[dd, :len(own)]
            v[own] = va[dd, :len(own)]
        kes.append(float(ke))
        done += k
    return x, v, np.asarray(kes)


def _force_rank(rank, n_dev, device, slabs, box, rc, halo_depth, beta,
                pme_grid):
    force = make_spatial_force_fn(None, box, rc, halo_depth, beta, pme_grid,
                                  device)
    e, f = force(*(torch.as_tensor(a[rank], device=device) for a in slabs))
    return float(e), f.cpu()


def run_spatial_force(n_dev: int, backend: str, device, xs, mask, q, s, e,
                      box, rc: float, halo_depth: int = 1, beta=None,
                      pme_grid=None):
    """Spawn n_dev ranks (parallel/launch.py), give rank r slab r of the
    [n_dev, cap, ...] arrays of partition_slabs, and return (E [n_dev],
    one total per rank, F [n_dev, cap, 3]) on the CPU."""
    from .launch import run_ranks

    slabs = tuple(np.asarray(a, np.float32) for a in (xs, mask, q, s, e))
    res = run_ranks(_force_rank, n_dev, backend, device,
                    (slabs, np.asarray(box), rc, halo_depth, beta, pme_grid))
    return np.array([r[0] for r in res]), torch.stack([r[1] for r in res])


def _md_rank(rank, n_dev, device, args, kw):
    return spatial_md_run(*args, group=None, device=device, **kw)


def run_spatial_md(n_dev: int, backend: str, device, x, v, masses, q, sig,
                   eps, box, **kw):
    """spatial_md_run on n_dev spawned ranks; rank 0's (x, v, ke history).
    `kw` are spatial_md_run's keyword arguments (rc, dt, n_steps, ...)."""
    from .launch import run_ranks

    args = tuple(np.asarray(a, np.float32) for a in (x, v, masses, q, sig,
                                                      eps)) + (
        np.asarray(box),)
    return run_ranks(_md_rank, n_dev, backend, device, (args, kw))[0]
