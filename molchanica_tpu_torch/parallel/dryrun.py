"""The JAX package's multichip dry run, end to end at a small size.

    dryrun_multidevice(4, "gloo", "cuda")

spawns n ranks (parallel/launch.py) that run its spatial paths on
torch.distributed: the dense slab force of one 64 n-atom system, a 4-step
sharded MD run with two re-partitions, and the sharded colpair kernel on a
600-atom sorted state against the single-device kernel.

    dryrun_replica_ti(4, devices=["cuda", "cuda"])

runs its replica-TI part in one process: an LJ bath with one coupled
particle, one lambda window per replica of a ReplicaFarm whose replica
axis is cut over `devices`, 3 equilibration and 6 recorded steps, TI with
SEM.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..constants import COULOMB_CONST
from ..device import resolve_device
from ..ops.colpair import (ColpairDirect, make_sort_fn, make_window_fn,
                           plan_columns)
from ..ops.pme import ewald_beta_for
from .spatial_colpair import (block, halo_depth_for,
                              make_sharded_colpair_direct, pad_plan_for_mesh)


def sorted_colpair_state(x, q, sig, eps, box, rc, n_dev, skin=0.5,
                         device=None):
    """(plan, rows [S, 8], wl, nw, box) of an atomic system (every atom
    its own exclusion group), per-site sorted and with triangular range
    tables, S padded to split into n_dev blocks. q in electron units,
    sig and eps the LJ sigma and epsilon. Built on the CPU, returned on
    `device` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    n = x.shape[0]
    beta = ewald_beta_for(rc, 1e-5)
    plan = pad_plan_for_mesh(plan_columns(box, rc, beta, n, n, skin=skin),
                             n_dev)
    boxt = torch.as_tensor(np.asarray(box), dtype=torch.float32)
    perm, keys, _, ovf = make_sort_fn(plan)(
        torch.as_tensor(x, dtype=torch.float32), boxt,
        torch.ones(n, dtype=torch.float32))
    xw = x - box * np.floor(x / box)
    base = np.concatenate([xw, np.stack([
        q * np.sqrt(COULOMB_CONST), sig / 2, 2 * np.sqrt(eps), np.zeros(n),
        1.0 + np.arange(n)], 1)], 1).astype(np.float32)
    base = np.concatenate([base, np.array([[1e6] * 3 + [0] * 5],
                                          np.float32)])
    rows = torch.as_tensor(base)[perm]
    wl, nw, wovf = make_window_fn(plan, per_slice_k=0)(
        rows[:, :3], keys, boxt, rows[:, 7])
    if int(ovf) or int(wovf):
        raise RuntimeError("sorted_colpair_state: table overflow")
    return plan, rows.to(dev), wl.to(dev), nw.to(dev), boxt.to(dev)


def _dryrun_rank(rank, n_dev, device):
    from .spatial import make_spatial_force_fn, partition_slabs, \
        spatial_md_run

    out = {}
    # dense slab decomposition of one system
    rng = np.random.default_rng(1)
    n_sp = 64 * n_dev
    box_sp = np.array([6.5 * n_dev, 13.0, 13.0])
    x_sp = rng.uniform(0, 1, (n_sp, 3)) * box_sp
    q_sp = rng.normal(0, 0.2, n_sp)
    sg = rng.uniform(1.2, 1.7, n_sp)
    ep = rng.uniform(0.1, 0.5, n_sp)
    xs, mask, owner = partition_slabs(x_sp, box_sp, n_dev)
    ids = owner[rank][owner[rank] >= 0]

    def mine(a):
        o = np.zeros(xs.shape[1], np.float32)
        o[:len(ids)] = a[ids]
        return torch.as_tensor(o, device=device)

    force = make_spatial_force_fn(None, box_sp, 6.0, device=device)
    e, f = force(torch.as_tensor(xs[rank], device=device),
                 torch.as_tensor(mask[rank], device=device), mine(q_sp),
                 mine(sg), mine(ep))
    out.update(n_sp=n_sp, e_dense=float(e),
               f_dense_finite=bool(torch.isfinite(f).all()))

    # sharded MD: 4 steps, a re-partition every 2
    gx, gy, gz = np.meshgrid(
        np.linspace(2, box_sp[0] - 2, 12), np.linspace(2, box_sp[1] - 2, 3),
        np.linspace(2, box_sp[2] - 2, 3), indexing="ij")
    x_lat = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    n_lat = len(x_lat)
    x_fin, _, kes = spatial_md_run(
        x_lat, np.zeros_like(x_lat), np.full(n_lat, 39.9, np.float32),
        np.zeros(n_lat, np.float32), np.full(n_lat, 1.7, np.float32),
        np.full(n_lat, 0.98, np.float32), box_sp, None, rc=6.0, dt=0.002,
        n_steps=4, rebuild_every=2, temp_target=120.0, device=device)
    out.update(n_lat=n_lat, kes=kes.tolist(),
               md_finite=bool(np.isfinite(x_fin).all()
                              and np.isfinite(kes).all()))

    # the sharded colpair kernel against one device
    rng = np.random.default_rng(5)
    box_cp = np.array([21.0, 21.0, 21.0])
    n_cp = 600
    x_cp = rng.uniform(0, 1, (n_cp, 3)) * box_cp
    plan, rows, wl, nw, boxt = sorted_colpair_state(
        x_cp, rng.normal(0, 0.3, n_cp), np.full(n_cp, 3.2),
        np.full(n_cp, 0.09), box_cp, 6.0, n_dev, device=device)
    halo = halo_depth_for(plan, n_dev, wl.cpu(), nw.cpu())
    couple = torch.ones((), device=device)
    sharded = make_sharded_colpair_direct(None, plan, halo, device=device)
    f_sh, _, _ = sharded(block(rows, rank, n_dev).contiguous(),
                         block(wl, rank, n_dev).contiguous(),
                         block(nw, rank, n_dev).contiguous(), boxt, couple)
    f_sh = sharded.comm.all_gather(f_sh)
    one = ColpairDirect(plan, want_energy=True, range_tables=True)
    f_ref, _, _ = one(rows, rows.T.contiguous(), wl, nw, boxt, couple)
    err = float((f_sh - f_ref).abs().max() / f_ref.abs().max())
    out.update(n_cp=n_cp, halo=halo, colpair_err=err,
               backend=sharded.comm.backend,
               launches=tracing.counters("colpair_"))
    return out


def dryrun_multidevice(n_devices: int = 4, backend: str = "gloo",
                       device="cuda") -> dict:
    """Run the spatial dry run on n_devices ranks over `backend`, each on
    `device` ("cuda" spreads the ranks over the cards, all on one card
    when there is one). Prints what it ran and returns rank 0's results;
    raises on non-finite output or a sharded colpair that parts from the
    single-device kernel by 5e-6 of max|F| or more."""
    from .launch import run_ranks

    res = run_ranks(_dryrun_rank, n_devices, backend, device)
    r0 = res[0]
    bad = [r for r, o in enumerate(res)
           if not (o["f_dense_finite"] and o["md_finite"]
                   and np.isfinite(o["e_dense"]))]
    if bad:
        raise RuntimeError(f"dryrun_multidevice: non-finite on ranks {bad}")
    worst = max(o["colpair_err"] for o in res)
    if not worst < 5e-6:
        raise RuntimeError(f"dryrun_multidevice: sharded colpair parts from "
                           f"one device by {worst:.2e} of max|F|")
    print(f"dryrun_multidevice OK over {n_devices} ranks ({r0['backend']}, "
          f"{device}): dense slab force of {r0['n_sp']} atoms, E="
          f"{r0['e_dense']:.4f}; sharded MD over {r0['n_lat']} atoms, 4 "
          f"steps / 2 re-partitions, KE {np.round(r0['kes'], 4).tolist()}; "
          f"sharded colpair ({r0['n_cp']} atoms, halo {r0['halo']}) "
          f"matches one device to {worst:.1e}", flush=True)
    return dict(r0, colpair_err=worst)


def dryrun_replica_ti(n_windows: int = 4, devices=None,
                      device=None) -> dict:
    """The replica-TI part of the multichip dry run: 20 LJ bath particles
    and one coupled particle in a 12 A box (allpairs_cutoff, Langevin
    gamma 2/ps at 120 K, FIRE over 100 iterations), n_windows lambda
    windows from 0 to 1 as the replicas of one ReplicaFarm cut over
    `devices` (None: one chunk on `device`, None meaning the CUDA card), 3
    steps of equilibration, then 6 steps with dH/dlambda recorded, TI with
    SEM. Returns the windows' lambdas and samples, dG, SEM, the final
    positions (numpy) and the farm's devices; raises on a non-finite
    result."""
    from ..md.alchemical import free_energy_ti_with_sem
    from ..md.config import Integrator, MdConfig
    from ..md.engine import MdSim
    from ..molecules.spec import MolSpec, assemble_system
    from .replicas import ReplicaFarm

    rngt = np.random.default_rng(7)
    baths = [MolSpec(masses=[39.9], charges=[0.0], lj_sigma=[3.3],
                     lj_eps=[0.25], positions=rngt.uniform(0, 12, (1, 3)))
             for _ in range(20)]
    solute = MolSpec(masses=[39.9], charges=[0.0], lj_sigma=[3.3],
                     lj_eps=[0.25], positions=np.array([[6.0, 6.0, 6.0]]))
    asys = assemble_system([solute] + baths, box_extent=np.array([12.0] * 3),
                           alchemical_mol=0)
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=2.0),
                   temp_target=120.0, lj_cutoff=5.0, coulomb_cutoff=5.0,
                   dtype="float32", max_init_relaxation_iters=100,
                   zero_com_drift=False, seed=3)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent, method="allpairs_cutoff",
                device=device)
    lams = np.linspace(0.0, 1.0, n_windows)
    farm = ReplicaFarm(sim, n_windows, couples=1.0 - lams, devices=devices,
                       seed=1)
    farm.step(0.002, 3)                       # equilibration
    farm.dhdl_trace = [[] for _ in range(n_windows)]
    farm.step(0.002, 6, record_dhdl=True)     # production + dH/dl
    windows = farm.windows()
    dg, sem = free_energy_ti_with_sem(windows)
    x = farm.x.detach().cpu().numpy()
    if not (np.isfinite(dg) and np.isfinite(sem) and np.isfinite(x).all()):
        raise RuntimeError(f"dryrun_replica_ti: dG {dg}, SEM {sem}, finite "
                           f"positions {bool(np.isfinite(x).all())}")
    devs = [str(d) for d in farm.devices]
    print(f"dryrun_replica_ti OK: {n_windows} lambda windows over "
          f"{len(devs)} chunks ({', '.join(devs)}), dynamics -> dH/dl -> "
          f"trapezoid TI, dG={dg:.3f}+-{sem:.3f} kcal/mol", flush=True)
    return dict(lams=[w.lam for w in windows],
                samples=[w.dhdl_samples.tolist() for w in windows], dg=dg,
                sem=sem, x=x, devices=devs)
