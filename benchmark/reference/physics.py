"""Plain float64 reference of one MD system: its potential energy and
forces, and one Langevin-middle step with its constraints.

Written from the stated physics alone, in plain torch. It reads the system
as raw arrays (a data file's topology fields) and imports nothing of the
program under test.

Energy (Amber functional forms, Ewald electrostatics, one cutoff rc):

  bonds       k (r - r0)^2
  angles      k (theta - theta0)^2
  dihedrals   k (1 + cos(n phi - phase)), IUPAC sign of phi
  direct      over site pairs with r < rc that are neither excluded nor
              1-4: 4 eps ((s/r)^12 - (s/r)^6), Lorentz-Berthelot mixing,
              plus K q_i q_j erfc(beta r) / r
  exclusions  over excluded and 1-4 pairs, at any distance:
              -K q_i q_j erf(beta r) / r (the smooth part the
              reciprocal sum holds for them)
  1-4         K q_i q_j / (scee r) + LJ / scnb, undamped
  reciprocal  smooth PME of order 6 (Essmann et al., J Chem Phys 103, 8577)
              on the configuration's mesh, tin-foil boundary, k = 0 dropped
  constants   self energy -beta / sqrt(pi) K sum q^2 and the neutralising
              background -K pi Q^2 / (2 beta^2 V)

beta solves erfc(beta rc) = ewald_rtol. The OPC M sites are massless: M =
O + w ((H1 - O) + (H2 - O)), placed before every evaluation, so the forces
on their parents come by the chain rule. Forces are -dE/dx by autograd in
float64.

Step (OpenMM's LangevinMiddle with one velocity projection after the kick
and one position projection after the last half drift):

  v1 = P_v(v + dt F(x) / m)            P_v: remove the constraint
  x1 = x + dt/2 v1                          components of the velocity
  v2 = c v1 + sqrt(kB T / m (1 - c^2)) z,   c = exp(-gamma dt)
  xu = x1 + dt/2 v2
  x2 = S(xu; x)                         S: SHAKE along the bonds at x
  v2 = v2 + (x2 - xu) / dt

Constraints: rigid waters (O-H, O-H, H-H) and X-H bonds, each solved to
float64 convergence.
"""
from __future__ import annotations

import math

import numpy as np
import torch

COULOMB_K = 332.0637128       # kcal A / (mol e^2)
KB = 0.001987204259           # kcal / (mol K)
ACCEL = 418.4                 # (kcal/mol/A) / amu -> A / ps^2
PME_ORDER = 6
F64 = torch.float64


def ewald_beta(rc: float, rtol: float) -> float:
    """beta with erfc(beta rc) = rtol, by bisection."""
    lo, hi = 0.0, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if math.erfc(mid * rc) > rtol:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _mi(d, box):
    return d - box * torch.round(d / box)


class System:
    """A system's raw arrays on `device` in float64, with the tables the
    reference needs (pair exclusions, constraints), built from them."""

    def __init__(self, arrays: dict, statics: dict, box, md: dict,
                 device):
        dev = torch.device(device)
        self.device = dev

        def f(name):
            return torch.as_tensor(np.asarray(arrays[name], np.float64),
                                   device=dev)

        def i(name):
            return torch.as_tensor(np.asarray(arrays[name], np.int64),
                                   device=dev)

        self.box = torch.as_tensor(np.asarray(box, np.float64), device=dev)
        self.n = int(np.asarray(arrays["masses"]).shape[0])
        self.mass = f("masses")
        self.q = f("charges") * f("atom_mask")
        self.sig = f("lj_sigma")
        self.eps = f("lj_eps")
        self.real = f("atom_mask") > 0.5
        self.dof = f("dof_mask")
        # the solute: integrated sites outside the water block
        ws = int(statics.get("water_start", 0))
        w_end = ws + int(statics["water_count"]) * int(
            statics.get("water_site_count", 0))
        k = torch.arange(self.n, device=dev)
        self.solute = (self.dof > 0) & ((k < ws) | (k >= w_end))
        self.rc = float(max(md["lj_cutoff"], md["coulomb_cutoff"]))
        self.beta = ewald_beta(float(md["coulomb_cutoff"]),
                               float(md.get("ewald_rtol", 1e-5)))
        self.grid = tuple(int(k) for k in md["pme_grid"])
        self.temp = float(md["temp_target"])
        self.gamma = float(md["integrator"][1]["gamma"])

        def rows(idx, mask):
            keep = np.asarray(arrays[mask]) > 0.5
            return torch.as_tensor(np.asarray(arrays[idx])[keep],
                                   dtype=torch.int64, device=dev), keep

        bond_keep = torch.as_tensor(np.asarray(arrays["bond_k"]) != 0,
                                    device=dev)
        self.bond = i("bond_idx")[bond_keep]
        self.bond_k = f("bond_k")[bond_keep]
        self.bond_r0 = f("bond_r0")[bond_keep]
        ang_keep = torch.as_tensor(np.asarray(arrays["angle_k"]) != 0,
                                   device=dev)
        self.angle = i("angle_idx")[ang_keep]
        self.angle_k = f("angle_k")[ang_keep]
        self.angle_t0 = f("angle_theta0")[ang_keep]
        dih_keep = torch.as_tensor(np.asarray(arrays["dihedral_k"]) != 0,
                                   device=dev)
        self.dih = i("dihedral_idx")[dih_keep]
        self.dih_k = f("dihedral_k")[dih_keep]
        self.dih_n = f("dihedral_n")[dih_keep]
        self.dih_ph = f("dihedral_phase")[dih_keep]
        self.excl, _ = rows("excl_idx", "excl_mask")
        self.p14, k14 = rows("pair14_idx", "pair14_mask")
        k14 = torch.as_tensor(k14, device=dev)
        self.scee = f("pair14_scee")[k14]
        self.scnb = f("pair14_scnb")[k14]
        # pairs the direct sum leaves out: excluded and 1-4, as sorted keys
        skip = torch.cat([self.excl, self.p14])
        a, b = skip.min(1).values, skip.max(1).values
        self.skip_keys = torch.unique(a * self.n + b)
        vs_keep = torch.as_tensor(np.asarray(arrays["vsite_mask"]) > 0.5,
                                  device=dev)
        self.vs = i("vsite_idx")[vs_keep]
        self.vs_w = f("vsite_weight")[vs_keep][:, None]
        self._constraints(arrays, statics, md)

    def _constraints(self, arrays, statics, md):
        """Three slots of constraints (i, j, d); no two constraints of one
        slot share an atom, so a slot is solved all at once."""
        slots = [[], [], []]
        wc = int(statics["water_count"])
        if wc:
            r_oh = float(statics["water_r_oh"])
            r_hh = 2.0 * r_oh * math.sin(0.5 * float(statics["water_theta_hoh"]))
            o = int(statics["water_start"]) + \
                int(statics["water_site_count"]) * np.arange(wc)
            for s, (a, b, d) in enumerate(((0, 1, r_oh), (0, 2, r_oh),
                                           (1, 2, r_hh))):
                slots[s] += [(int(x) + a, int(x) + b, d) for x in o]
        if md["hydrogen_constraint"][0] != "flexible":
            heavy = np.asarray(arrays["hcluster_heavy"])
            hs = np.asarray(arrays["hcluster_h"])
            r0 = np.asarray(arrays["hcluster_r0"], np.float64)
            for c in range(heavy.shape[0]):
                for s in range(3):
                    if hs[c, s] >= 0:
                        slots[s].append((int(heavy[c]), int(hs[c, s]),
                                         float(r0[c, s])))
        self.cons = []
        for sl in slots:
            if sl:
                a = torch.tensor([c[0] for c in sl], device=self.device)
                b = torch.tensor([c[1] for c in sl], device=self.device)
                d = torch.tensor([c[2] for c in sl], dtype=F64,
                                 device=self.device)
                self.cons.append((a, b, d))
        self.n_constraints = sum(int(c[0].numel()) for c in self.cons)

    # ------------------------------------------------------------------
    def place(self, x):
        """x with the massless M rows placed from their parents."""
        if self.vs.numel() == 0:
            return x
        m, o, h1, h2 = self.vs.unbind(1)
        xm = x[o] + self.vs_w * ((x[h1] - x[o]) + (x[h2] - x[o]))
        return x.index_put((m,), xm)

    def pairs(self, x, skin: float = 0.5, chunk: int = 2048,
              include_skipped: bool = False):
        """[P, 2] site pairs i < j within rc + skin of each other (float32
        search; the energy applies the exact cutoff), without the excluded
        and 1-4 pairs unless include_skipped."""
        xs = self.place(x.detach()).to(torch.float32)
        box = self.box.to(torch.float32)
        real = torch.nonzero(self.real).squeeze(1)
        xr = xs[real]
        lim = (self.rc + skin) ** 2
        out = []
        for c0 in range(0, real.numel(), chunk):
            d = _mi(xr[c0:c0 + chunk, None, :] - xr[None, :, :], box)
            hit = (d * d).sum(-1) < lim
            a, b = torch.nonzero(hit, as_tuple=True)
            a = a + c0
            keep = b > a
            out.append(torch.stack([real[a[keep]], real[b[keep]]], 1))
        p = torch.cat(out)
        if not include_skipped:
            keys = p[:, 0] * self.n + p[:, 1]
            p = p[~torch.isin(keys, self.skip_keys)]
        return p

    def count_pairs(self, x) -> int:
        """Site pairs within rc, excluded and 1-4 pairs included (what a
        direct-space kernel that subtracts them again evaluates)."""
        p = self.pairs(x, skin=0.05, include_skipped=True)
        xs = self.place(x.detach().to(F64))
        d = _mi(xs[p[:, 0]] - xs[p[:, 1]], self.box)
        return int(((d * d).sum(-1) < self.rc ** 2).sum())

    # ------------------------------------------------------------------
    def _bonded(self, x):
        box = self.box
        e = x.new_zeros(())
        if self.bond.numel():
            d = _mi(x[self.bond[:, 0]] - x[self.bond[:, 1]], box)
            r = torch.linalg.norm(d, dim=1)
            e = e + (self.bond_k * (r - self.bond_r0) ** 2).sum()
        if self.angle.numel():
            a, b, c = self.angle.unbind(1)
            u = _mi(x[a] - x[b], box)
            w = _mi(x[c] - x[b], box)
            th = torch.atan2(torch.linalg.norm(torch.linalg.cross(u, w), dim=1),
                             (u * w).sum(1))
            e = e + (self.angle_k * (th - self.angle_t0) ** 2).sum()
        if self.dih.numel():
            a, b, c, d_ = self.dih.unbind(1)
            b1 = _mi(x[b] - x[a], box)
            b2 = _mi(x[c] - x[b], box)
            b3 = _mi(x[d_] - x[c], box)
            n1 = torch.linalg.cross(b1, b2)
            n2 = torch.linalg.cross(b2, b3)
            y = torch.linalg.norm(b2, dim=1) * (b1 * n2).sum(1)
            phi = torch.atan2(y, (n1 * n2).sum(1))
            e = e + (self.dih_k * (1.0 + torch.cos(self.dih_n * phi
                                                   - self.dih_ph))).sum()
        return e

    def _direct(self, x, pairs):
        i, j = pairs[:, 0], pairs[:, 1]
        d = _mi(x[i] - x[j], self.box)
        r2 = (d * d).sum(1)
        inside = r2 < self.rc ** 2
        i, j, r2 = i[inside], j[inside], r2[inside]
        r = torch.sqrt(r2)
        s = 0.5 * (self.sig[i] + self.sig[j])
        eps = torch.sqrt(self.eps[i] * self.eps[j])
        s6 = (s * s / r2) ** 3
        e_lj = 4.0 * eps * (s6 * s6 - s6)
        e_c = COULOMB_K * self.q[i] * self.q[j] * torch.erfc(self.beta * r) / r
        return e_lj.sum() + e_c.sum()

    def _pair_corrections(self, x):
        box = self.box
        e = x.new_zeros(())
        for idx in (self.excl, self.p14):
            if idx.numel():
                d = _mi(x[idx[:, 0]] - x[idx[:, 1]], box)
                r = torch.linalg.norm(d, dim=1)
                qq = self.q[idx[:, 0]] * self.q[idx[:, 1]]
                e = e - (COULOMB_K * qq * torch.erf(self.beta * r) / r).sum()
        if self.p14.numel():
            i, j = self.p14[:, 0], self.p14[:, 1]
            d = _mi(x[i] - x[j], box)
            r2 = (d * d).sum(1)
            r = torch.sqrt(r2)
            s = 0.5 * (self.sig[i] + self.sig[j])
            eps = torch.sqrt(self.eps[i] * self.eps[j])
            s6 = (s * s / r2) ** 3
            e = e + (4.0 * eps * (s6 * s6 - s6) / self.scnb).sum()
            e = e + (COULOMB_K * self.q[i] * self.q[j] / (self.scee * r)).sum()
        return e

    def _recip(self, x):
        K = torch.tensor(self.grid, dtype=F64, device=x.device)
        box = self.box
        charged = torch.nonzero(self.q != 0).squeeze(1)
        q = self.q[charged]
        u = x[charged] / box * K
        base = torch.floor(u)
        frac = u - base
        # B-spline M_6 at frac + k, k = 0..5, by the Cox-de Boor recursion;
        # grid point base - k gets the weight M_6(u - (base - k))
        t = frac[..., None] + torch.arange(PME_ORDER, dtype=F64,
                                           device=x.device)
        m = torch.clamp(1.0 - torch.abs(t - 1.0), min=0.0)      # M_2
        for n in range(3, PME_ORDER + 1):
            m = (t * m + (n - t) * torch.cat(
                [torch.zeros_like(m[..., :1]), m[..., :-1]], -1)) / (n - 1)
        kk = torch.arange(PME_ORDER, device=x.device)
        gx, gy, gz = [torch.remainder(base[:, a, None].long() - kk, self.grid[a])
                      for a in range(3)]
        w = (m[:, 0, :, None, None] * m[:, 1, None, :, None]
             * m[:, 2, None, None, :]) * q[:, None, None, None]
        flat = ((gx[:, :, None, None] * self.grid[1] + gy[:, None, :, None])
                * self.grid[2] + gz[:, None, None, :])
        Q = torch.zeros(self.grid[0] * self.grid[1] * self.grid[2],
                        dtype=F64, device=x.device)
        Q = Q.index_add(0, flat.reshape(-1), w.reshape(-1))
        S = torch.fft.fftn(Q.reshape(self.grid))
        infl = self._influence().to(x.device)
        vol = box.prod()
        e = COULOMB_K / (2.0 * vol) * (infl * (S.real ** 2 + S.imag ** 2)).sum()
        qtot = self.q.sum()
        e_bg = -COULOMB_K * math.pi / (2.0 * self.beta ** 2 * vol) * qtot ** 2
        e_self = -self.beta / math.sqrt(math.pi) * COULOMB_K * (self.q ** 2).sum()
        return e + e_bg + e_self

    def _influence(self):
        if getattr(self, "_infl", None) is not None:
            return self._infl
        box = self.box.cpu().numpy()
        b2 = []
        # |b(m)|^2 = 1 / |sum_{k=0}^{n-2} M_n(k+1) exp(2 pi i m k / K)|^2
        nodes = _bspline_nodes(PME_ORDER)
        for K in self.grid:
            mm = np.arange(K)
            den = sum(nodes[k] * np.exp(2j * np.pi * mm * k / K)
                      for k in range(PME_ORDER - 1))
            b2.append(1.0 / np.abs(den) ** 2)
        ks = [2.0 * np.pi * np.fft.fftfreq(K) * K / L
              for K, L in zip(self.grid, box)]
        k2 = (ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
              + ks[2][None, None, :] ** 2)
        with np.errstate(divide="ignore"):
            infl = 4.0 * np.pi / k2 * np.exp(-k2 / (4.0 * self.beta ** 2))
        infl[0, 0, 0] = 0.0
        infl *= b2[0][:, None, None] * b2[1][None, :, None] \
            * b2[2][None, None, :]
        self._infl = torch.as_tensor(infl, dtype=F64, device=self.device)
        return self._infl

    def energy(self, x, pairs):
        xs = self.place(x)
        return (self._bonded(xs) + self._direct(xs, pairs)
                + self._pair_corrections(xs) + self._recip(xs))

    def forces(self, x, pairs=None):
        """(F [N, 3], E) at x [N, 3] (float64; M rows are placed here)."""
        x = x.to(F64).detach()
        if pairs is None:
            pairs = self.pairs(x)
        with torch.enable_grad():
            xg = x.clone().requires_grad_(True)
            e = self.energy(xg, pairs)
            (g,) = torch.autograd.grad(e, xg)
        return -g, float(e.detach())

    # ------------------------------------------------------------------
    def _inv_m(self, idx):
        return torch.where(self.dof[idx] > 0, 1.0 / self.mass[idx],
                           torch.zeros_like(self.mass[idx]))

    def shake(self, x_new, x_ref, tol=1e-13, max_sweeps=10000):
        """x_new moved along the bond vectors of x_ref until every
        constraint holds (SHAKE, Gauss-Seidel over the slots)."""
        x = x_new.clone()
        for _ in range(max_sweeps):
            worst = 0.0
            for a, b, d in self.cons:
                s = _mi(x[a] - x[b], self.box)
                r0 = _mi(x_ref[a] - x_ref[b], self.box)
                ia, ib = self._inv_m(a), self._inv_m(b)
                diff = (s * s).sum(1) - d * d
                g = diff / (2.0 * (s * r0).sum(1) * (ia + ib))
                x = x.index_add(0, a, -(g * ia)[:, None] * r0)
                x = x.index_add(0, b, (g * ib)[:, None] * r0)
                worst = max(worst, float((diff.abs() / (d * d)).max()))
            if worst < tol:
                return x
        raise RuntimeError(f"reference SHAKE did not converge ({worst:.3e})")

    def rattle(self, v, x, tol=1e-13, max_sweeps=10000):
        """v without its components along the constraints at x."""
        v = v.clone()
        for _ in range(max_sweeps):
            worst = 0.0
            for a, b, d in self.cons:
                r = _mi(x[a] - x[b], self.box)
                ia, ib = self._inv_m(a), self._inv_m(b)
                rv = (r * (v[a] - v[b])).sum(1)
                k = rv / ((r * r).sum(1) * (ia + ib))
                v = v.index_add(0, a, -(k * ia)[:, None] * r)
                v = v.index_add(0, b, (k * ib)[:, None] * r)
                worst = max(worst, float((rv.abs() / d).max()))
            if worst < tol:
                return v
        raise RuntimeError(f"reference RATTLE did not converge ({worst:.3e})")

    def step(self, x, v, z, f, dt):
        """One Langevin-middle step from (x, v) with the standard normals z
        and the force f at x: (x', v')."""
        x, v, z, f = (t.to(F64) for t in (x, v, z, f))
        dm = self.dof[:, None]
        inv_m = torch.where(self.dof > 0, 1.0 / self.mass,
                            torch.zeros_like(self.mass))[:, None]
        c = math.exp(-self.gamma * dt)
        sigma = torch.sqrt(KB * self.temp * ACCEL * inv_m * (1.0 - c * c))
        v1 = self.rattle(v + dt * ACCEL * f * inv_m * dm, x)
        x1 = x + 0.5 * dt * v1 * dm
        v2 = (c * v1 + sigma * z) * dm
        xu = x1 + 0.5 * dt * v2 * dm
        x2 = self.shake(xu, x)
        return x2, v2 + (x2 - xu) / dt

    def temperature(self, v) -> float:
        ke = 0.5 * (self.mass * self.dof * (v.to(F64) ** 2).sum(1)).sum() / ACCEL
        ndof = max(3.0 * float(self.dof.sum()) - self.n_constraints - 3.0, 1.0)
        return float(2.0 * ke / (KB * ndof))

    def constraint_error(self, x) -> float:
        """Largest |r - d| / d over the constraints at x."""
        worst = 0.0
        for a, b, d in self.cons:
            r = torch.linalg.norm(_mi(x[a].to(F64) - x[b].to(F64), self.box),
                                  dim=1)
            worst = max(worst, float(((r - d).abs() / d).max()))
        return worst


def _bspline_nodes(order):
    """M_order(k + 1) for k = 0..order-2."""
    u = np.arange(1, order, dtype=np.float64)
    m = np.maximum(1.0 - np.abs(u - 1.0), 0.0)
    for n in range(3, order + 1):
        m = (u * m + (n - u) * np.concatenate([[0.0], m[:-1]])) / (n - 1)
    return m
