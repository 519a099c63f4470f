"""ReplicaFarm: R independent simulations of one topology, advanced in
lockstep as batched tensors (port of molchanica_tpu.parallel.replicas).

The JAX farm vmaps one replica's step and lays the replica axis over a
device mesh. Here every tensor of a farm step carries the replica axis:
the neighbour rebuild, the direct space, PME, the bonded and exclusion
terms, the constraints and the integrator each run once for all replicas
of a chunk, so a farm step issues the launches of one MdSim step, not R
times as many. The pure per-replica functions are batched by
torch.func.vmap; what vmap cannot take is batched by hand: forces and
dH/dlambda by torch.autograd over the summed [R] energies (autograd does
not run inside vmap), PME by `Pme3.batched`, and the cell-grid kernel K2
and the cluster force kernel by one launch with a replica axis in its
grid (ops/direct_force.py, csrc/direct_force.cu; ops/clusters.py,
csrc/cluster_force.cu).

One farm step per replica, as the reference's `replica_step`:
  on the cluster and K2 backends: the M sites placed and the neighbour
      state rebuilt from the current x (every step, so no overflow from
      motion between rebuilds), f0 = force(x) afresh, one integrator step,
      dH/dlambda, the overflow of the rebuild and the step;
  on allpairs, allpairs_cutoff and window: the same without the rebuild.
No COM removal, barostat or external force: the reference farm applies
none. dH/dlambda is computed only on the steps that record it (nothing
reads it on the others).

`devices` cuts the replica axis into contiguous chunks, one per device,
with no communication (the reference's NamedSharding over a 1-axis mesh);
a chunk on another device than the MdSim's runs a copy of its force paths
made there from the same plan.

The phases run inside spans of molchanica_tpu_torch.tracing (no-ops while
tracing is off): `farm.call` (a call of step), `farm.step`, `farm.draws`,
`direct.rebuild`, `farm.force` (each force evaluation) with `direct.force`,
`pme` (and `pme.backward` in ops/pme3.py), `rest.energy` and `rest.grad`,
`farm.integrate`, `constraints` and `farm.overflow_read` (the host's
synchronize); on K2 also `k2.rebuild` inside `direct.rebuild`, and
`k2.inputs` and `k2.kernel` inside `direct.force` (ops/direct_force.py);
benchmark/spans.py reads them.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from .. import tracing
from ..constants import ACCEL_FACTOR, KB
from ..md.alchemical import LambdaWindow
from ..md.energy import apply_virtual_sites, make_energy_fn
from ..md.engine import add_direct_terms
from ..md.integrators import make_integrator_step
from ..ops.direct_force import image_shift


def _detach(terms):
    return {k: v.detach() for k, v in terms.items()}


def _in_span(name, fn):
    """fn, each call inside tracing.span(name); None stays None."""
    if fn is None:
        return None

    def call(*args):
        with tracing.span(name):
            return fn(*args)
    return call


class _Batched:
    """One MdSim's force paths with a leading replica axis: rebuild(x, box)
    -> (nbr, overflow [R] or None), force(x, box, c, nbr) -> (F [R, N, 3],
    (E [R], terms)), dhdl(x, box, c) -> [R], and the constraints."""

    def __init__(self, sim):
        self.sim = sim
        top = sim.top
        self.place = vmap(lambda x: apply_virtual_sites(x, top))
        self.cp = _in_span("constraints",
                           None if sim._cp is None else vmap(sim._cp))
        self.cv = _in_span("constraints",
                           None if sim._cv is None else vmap(sim._cv))
        self.evals = 0
        if sim.method != "cells_pme":
            self._energy = vmap(sim.energy_fn, in_dims=(0, None, 0))
            self.rebuild = lambda x, box: ((), None)
            self.force = self._force_autograd
            self.dhdl = self._dhdl_autograd
            return
        beta = sim._beta
        backend = sim._nbr_backend
        if backend == "pallas":
            rebuild1 = vmap(sim._rebuild, in_dims=(0, None))

            def rebuild(xv, box):
                sa, inv, ovf = rebuild1(xv, box)
                return (sa, inv, image_shift(xv, box)), ovf

            def direct(xv, box, c, nbr, want_force):
                return sim._direct(xv, box, c, beta, *nbr)[:3] + (None,)
        elif backend == "clusters":
            rebuild1 = vmap(sim._rebuild, in_dims=(0, None))

            def rebuild(xv, box):
                order, nbr, flags, ovf = rebuild1(xv, box)
                return (order, nbr, flags), ovf

            def direct(xv, box, c, nbr, want_force):
                # the replica axis natively: one kernel launch on the card,
                # the plain twin under vmap on the CPU
                return sim._direct(xv, box, c, beta, *nbr,
                                   want_force=want_force)[:3] + (None,)
        else:
            def rebuild(xv, box):
                return (), None

            def one(want_force, x, box, c):
                f, e_lj, e_c, ovf = sim._direct(x, box, c, beta,
                                                want_force=want_force)
                return ((f, e_lj, e_c, ovf) if want_force
                        else (e_lj, e_c, ovf))

            batched = {w: vmap(functools.partial(one, w),
                               in_dims=(0, None, 0)) for w in (False, True)}

            def direct(xv, box, c, nbr, want_force):
                out = tuple(batched[want_force](xv, box, c))
                return out if want_force else (None,) + out
        # direct(xv, box, c, nbr, want_force) -> (F or None, e_lj, e_c,
        # the window's binning overflow [R] or None)
        self.rebuild = rebuild
        self._direct = direct
        self._spread = vmap(sim._spread)
        # the rest energy with its reciprocal term passed in per replica:
        # PME runs outside vmap (Pme3.batched), the sums keep the order of
        # the single-replica energy
        self._rest = vmap(make_energy_fn(top, sim.cfg, "pme_rest"),
                          in_dims=(0, None, 0, 0))
        self.force = self._force_cells
        self.dhdl = self._dhdl_fd

    # -- allpairs and allpairs_cutoff: autograd of the batched energy --
    def _force_autograd(self, x, box, c, nbr):
        self.evals += 1
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            e, terms = self._energy(xg, box, c)
            (g,) = torch.autograd.grad(e.sum(), xg)
        return -g, (e.detach(), _detach(terms))

    def _dhdl_autograd(self, x, box, c):
        with torch.enable_grad():
            cg = c.detach().clone().requires_grad_(True)
            e = self._energy(x.detach(), box, cg)[0]
            (g,) = torch.autograd.grad(e.sum(), cg)
        return -g

    # -- cells_pme: analytic direct space + autograd of the rest --
    def _force_cells(self, x, box, c, nbr):
        self.evals += 1
        with tracing.span("farm.force"):
            xv = self.place(x)
            with tracing.span("direct.force"):
                f1, e_lj, e_c, ovf = self._direct(xv, box, c, nbr, True)
            f1 = self._spread(f1)
            with torch.enable_grad():
                xg = xv.detach().requires_grad_(True)
                xp = self.place(xg)
                with tracing.span("pme"):
                    e_recip = self.sim._recip.batched(xp, box, c)
                with tracing.span("rest.energy"):
                    e_rest, terms = self._rest(xg, box, c, e_recip)
                with tracing.span("rest.grad"):
                    (g,) = torch.autograd.grad(e_rest.sum(), xg)
            return f1 - g, add_direct_terms(e_rest.detach(), _detach(terms),
                                            e_lj, e_c, ovf)

    def _energy_cells(self, x, box, c):
        """[R] total energies with a fresh rebuild, no forces (MdSim's
        force_fn energies)."""
        self.evals += 1
        xv = self.place(x)
        nbr, _ = self.rebuild(xv, box)
        _, e_lj, e_c, _ = self._direct(xv, box, c, nbr, False)
        e_recip = self.sim._recip.batched(xv, box, c)
        return self._rest(xv, box, c, e_recip)[0] + e_lj + e_c

    def _dhdl_fd(self, x, box, c):
        """MdSim.dhdl_fn per replica: the central difference in couple of
        the energy (h = 1e-3); d/dlambda = -d/dcouple. Zero without coupled
        atoms."""
        if float(self.sim.top.couple_mask.sum()) == 0:
            return torch.zeros_like(c)
        h = 1e-3
        ep = self._energy_cells(x, box, c + h)
        em = self._energy_cells(x, box, c - h)
        return -(ep - em) / (2.0 * h)


def _canonical(device) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _twin(sim, device):
    """sim's force paths on another device: the same topology, config and
    neighbour plan (made from the positions sim's plan was made from)."""
    from ..md.engine import MdSim

    tw = MdSim(sim.top, sim.cfg, sim._plan_x0, box_extent=sim._box_np,
               velocities=np.zeros(sim._plan_x0.shape, sim.cfg.dtype),
               method=sim.method, relax=False, device=device)
    if sim._m_scale != tw._m_scale:
        tw._m_scale = sim._m_scale
        tw._build_force_paths(sim._plan_x0)
    return tw


class _Chunk:
    """Replicas [lo, hi) of the farm on one device."""

    def __init__(self, sim, lo, hi, x, v, couples):
        self.lo, self.hi = lo, hi
        self.b = _Batched(sim)
        dev = sim.device
        self.x = x[lo:hi].to(dev)
        self.v = v[lo:hi].to(dev)
        self.c = couples[lo:hi].to(dev, sim.dtype)
        self.box = sim.state.box
        self.sim = sim
        self.nbr = None
        self._one = {}

    def one_step(self, dt):
        if dt not in self._one:
            sim, b = self.sim, self.b
            ic = sim.cfg.integrator
            self._one[dt] = make_integrator_step(
                lambda x_: b.force(x_, self.box, self.c, self.nbr),
                sim.top.masses, sim.top.dof_mask, ic.kind, dt=dt,
                temp_target=sim.cfg.temp_target,
                thermostat_tau=ic.thermostat_tau, gamma=ic.gamma,
                constrain_positions=b.cp, constrain_velocities=b.cv,
                cadence=ic.cadence, n_constraints=sim.n_constraints)
        return self._one[dt]

    def step(self, dt, noise, record_dhdl):
        """One farm step of this chunk: (E [R], dH/dlambda [R] or None,
        overflow [R] int64)."""
        b = self.b
        with tracing.span("direct.rebuild"):
            self.nbr, ovf = b.rebuild(b.place(self.x), self.box)
        f0 = b.force(self.x, self.box, self.c, self.nbr)[0]
        with tracing.span("farm.integrate"):
            x, v, _, e, terms = self.one_step(dt)(self.x, self.v, f0, noise)
        self.x, self.v = x, v
        ovf_step = terms["cell_overflow"].to(torch.int64)
        if ovf is not None:
            ovf_step = ovf_step + ovf
        dhdl = b.dhdl(x, self.box, self.c) if record_dhdl else None
        return e, dhdl, ovf_step


class ReplicaFarm:
    """Fan a prepared MdSim out into n_replicas independent copies.

    couples: per-replica coupling strengths (1 - lambda), all ones by
    default. devices: torch devices over which the replica axis is cut
    into contiguous chunks (None: one chunk on the MdSim's device). seed:
    the farm's torch.Generator (on the MdSim's device), which draws the
    jitter and every step's random numbers for all replicas at once.
    jitter > 0 displaces each replica's start by jitter x N(0, 1) on the
    integrated atoms."""

    def __init__(self, sim, n_replicas: int,
                 couples: Optional[Sequence[float]] = None,
                 devices: Optional[Sequence] = None, seed: int = 0,
                 jitter: float = 0.0):
        self.sim = sim
        self.n = R = int(n_replicas)
        self.generator = torch.Generator(device=sim.device)
        self.generator.manual_seed(seed)
        s = sim.state
        x = s.positions[None].repeat(R, 1, 1)
        if jitter > 0:
            x = x + jitter * torch.randn(
                x.shape, generator=self.generator, dtype=x.dtype,
                device=x.device) * sim.top.dof_mask[None, :, None]
        v = s.velocities[None].repeat(R, 1, 1)
        if couples is None:
            couples = np.ones(R)
        self.couples = torch.as_tensor(np.asarray(couples, np.float32),
                                       device=sim.device)
        if self.couples.shape != (R,):
            raise ValueError(f"couples: want {R} values, got "
                             f"{tuple(self.couples.shape)}")
        devs = [_canonical(sim.device)] if devices is None else \
            [_canonical(d) for d in devices]
        if not 0 < len(devs) <= R:
            raise ValueError(f"devices: 1 to {R} devices, got {len(devs)}")
        cuts = np.linspace(0, R, len(devs) + 1).round().astype(int)
        owners = {_canonical(sim.device): sim}
        self._chunks = []
        for k, dev in enumerate(devs):
            if dev not in owners:
                owners[dev] = _twin(sim, dev)
            self._chunks.append(_Chunk(owners[dev], int(cuts[k]),
                                       int(cuts[k + 1]), x, v, self.couples))
        self.dhdl_trace = [[] for _ in range(R)]
        self.step_count = 0

    @property
    def devices(self):
        return [ch.sim.device for ch in self._chunks]

    @property
    def force_evals(self) -> int:
        """Batched force and energy evaluations, summed over the chunks."""
        return sum(ch.b.evals for ch in self._chunks)

    def _gather(self, name):
        parts = [getattr(ch, name) for ch in self._chunks]
        dev = parts[0].device
        return parts[0] if len(parts) == 1 else \
            torch.cat([p.to(dev) for p in parts])

    @property
    def x(self):
        """[R, N, 3] positions (on the first chunk's device)."""
        return self._gather("x")

    @property
    def v(self):
        """[R, N, 3] velocities (on the first chunk's device)."""
        return self._gather("v")

    def temperatures(self) -> np.ndarray:
        """[R] instantaneous temperatures (K), as MdSim.temperature()."""
        sim = self.sim
        v = self.v.detach().to("cpu", torch.float64)
        m = sim.top.masses.detach().to("cpu", torch.float64)
        d = sim.top.dof_mask.detach().to("cpu", torch.float64)
        ke = 0.5 * (m * d * (v * v).sum(-1)).sum(-1) / ACCEL_FACTOR
        ndof = max(3.0 * float(d.sum()) - sim.n_constraints - 3.0, 1.0)
        return (2.0 * ke / (KB * ndof)).numpy()

    def _draws(self):
        """This step's random numbers for all replicas, cut per chunk:
        Langevin noise [R, N, 3], CSVR (r1 [R], s [R]), else None."""
        sim = self.sim
        ic = sim.cfg.integrator
        gen = self.generator
        kw = dict(generator=gen, dtype=sim.dtype, device=sim.device)
        if ic.kind == "langevin_middle":
            z = torch.randn((self.n,) + tuple(sim.state.positions.shape),
                            **kw)
            return [z[ch.lo:ch.hi].to(ch.sim.device) for ch in self._chunks]
        if ic.thermostat_tau is not None:
            z = torch.randn((self.n, max(sim._ndof, 1)), **kw)
            r1, s = z[:, 0], torch.sum(z[:, 1:] * z[:, 1:], dim=1)
            return [(r1[ch.lo:ch.hi].to(ch.sim.device),
                     s[ch.lo:ch.hi].to(ch.sim.device))
                    for ch in self._chunks]
        return [None] * len(self._chunks)

    def _check(self, acc):
        with tracing.span("farm.overflow_read"):
            ovf = max(int(a.max()) for a in acc)
        if ovf > 0:
            raise RuntimeError(
                f"ReplicaFarm neighbor overflow ({ovf}): cell/cluster "
                "capacity exceeded in at least one replica — rebuild the "
                "farm with a larger capacity margin")

    @torch.no_grad()
    def step(self, dt_ps: float, n_steps: int = 1, record_dhdl=False):
        """Advance every replica n_steps; returns the last step's energies
        [R] (numpy). With record_dhdl, each step's dH/dlambda is appended
        to `dhdl_trace`. A neighbour overflow in any replica (dropped pairs
        would corrupt forces and dH/dlambda unseen) raises RuntimeError; it
        is read every 64 steps, on every recording step and at the end."""
        with tracing.span("farm.call"):
            dt = float(dt_ps)
            acc = [torch.zeros(ch.hi - ch.lo, dtype=torch.int64,
                               device=ch.sim.device) for ch in self._chunks]
            energies = None
            for i in range(n_steps):
                with tracing.span("farm.step"):
                    with tracing.span("farm.draws"):
                        draws = self._draws()
                    out = [ch.step(dt, d, record_dhdl)
                           for ch, d in zip(self._chunks, draws)]
                    for k, (_, _, ovf) in enumerate(out):
                        acc[k] = torch.maximum(acc[k], ovf)
                    energies = [e for e, _, _ in out]
                    if record_dhdl:
                        d = torch.cat([dh.detach().cpu()
                                       for _, dh, _ in out])
                        for r, val in enumerate(d.tolist()):
                            self.dhdl_trace[r].append(float(val))
                        self._check(acc)
                    elif i % 64 == 63:
                        self._check(acc)
            self._check(acc)
            self.step_count += n_steps
            if energies is None:
                return None
            return torch.cat([e.detach().cpu() for e in energies]).numpy()

    def windows(self):
        """Per-replica LambdaWindow objects from the recorded dH/dlambda
        trace, lambda = 1 - couple."""
        lams = 1.0 - self.couples.cpu().numpy()
        return [LambdaWindow(lam=float(lams[r]),
                             dhdl_samples=np.asarray(self.dhdl_trace[r]))
                for r in range(self.n)]
