"""Water models (OPC 4-site, TIP3P 3-site) and water-box construction.

Copy of molchanica_tpu.systems.water. Parameters below are the published
model constants (public data):

OPC  (Izadi, Anandakrishnan & Onufriev 2014):
  r_OH = 0.8724 A, theta_HOH = 103.6 deg, r_OM = 0.1594 A,
  q_H = +0.679142, q_M = -1.358284, O: sigma = 3.16655 A,
  eps = 0.212801 kcal/mol (0.89036 kJ/mol). O carries LJ, M carries charge.

TIP3P (Jorgensen 1983):
  r_OH = 0.9572 A, theta = 104.52 deg, q_O = -0.834, q_H = +0.417,
  O: sigma = 3.15061 A, eps = 0.1521 kcal/mol.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

DEG = math.pi / 180.0


@dataclass(frozen=True)
class WaterModel:
    name: str
    site_count: int          # 3 or 4 (O, H, H[, M])
    r_oh: float
    theta_hoh: float         # radians
    r_om: float
    q_o: float
    q_h: float
    q_m: float
    sigma_o: float
    eps_o: float
    sigma_h: float = 0.0     # TIP3P/OPC H has no LJ
    eps_h: float = 0.0

    @property
    def masses(self):
        m = [15.9994, 1.008, 1.008]
        if self.site_count == 4:
            m.append(0.0)    # massless M (virtual site)
        return m

    @property
    def charges(self):
        q = [self.q_o, self.q_h, self.q_h]
        if self.site_count == 4:
            q.append(self.q_m)
        return q

    @property
    def vsite_weight(self):
        """M = O + w ((H1-O) + (H2-O)), exact for the rigid geometry."""
        if self.site_count != 4:
            return 0.0
        return self.r_om / (2.0 * self.r_oh * math.cos(0.5 * self.theta_hoh))


OPC = WaterModel(
    name="opc", site_count=4,
    r_oh=0.87243, theta_hoh=103.6 * DEG, r_om=0.15939,
    q_o=0.0, q_h=0.679142, q_m=-1.358284,
    sigma_o=3.16655, eps_o=0.212801,
)

TIP3P = WaterModel(
    name="tip3p", site_count=3,
    r_oh=0.9572, theta_hoh=104.52 * DEG, r_om=0.0,
    q_o=-0.834, q_h=0.417, q_m=0.0,
    sigma_o=3.15061, eps_o=0.1521,
)

# molecules per A^3 at 0.997 g/cm^3
WATER_NUMBER_DENSITY = 0.03334


def water_geometry(model: WaterModel):
    """Canonical site positions for one water (O at origin, bisector +x)."""
    h = model.theta_hoh / 2.0
    o = np.zeros(3)
    h1 = model.r_oh * np.array([math.cos(h), math.sin(h), 0.0])
    h2 = model.r_oh * np.array([math.cos(h), -math.sin(h), 0.0])
    sites = [o, h1, h2]
    if model.site_count == 4:
        sites.append(np.array([model.r_om, 0.0, 0.0]))
    return np.stack(sites)


def _random_rotations(n, rng):
    """Uniform random rotation matrices via quaternion sampling."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def fill_water_positions(box_extent, exclude_positions=None,
                         exclude_radius: float = 2.6, model: WaterModel = OPC,
                         n_target: int = None, seed: int = 0,
                         region=None):
    """Lattice-pack water molecules into the box, avoiding solute clashes.

    Returns [W, site_count, 3] positions.
    """
    rng = np.random.default_rng(seed)
    box = np.asarray(box_extent, np.float64)
    spacing = (1.0 / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)   # ~3.104 A
    if region is not None:
        lo = np.asarray(region[0], np.float64)
        hi = np.asarray(region[1], np.float64)
    else:
        lo = np.zeros(3)
        hi = box
    ext = hi - lo
    # when a target count is requested, over-generate candidates (ceil)
    # and trim by random selection; otherwise stay at bulk density
    rounder = np.ceil if n_target is not None else np.floor
    n = np.maximum(rounder(ext / spacing).astype(int), 1)
    xs = lo[0] + (np.arange(n[0]) + 0.5) * ext[0] / n[0]
    ys = lo[1] + (np.arange(n[1]) + 0.5) * ext[1] / n[1]
    zs = lo[2] + (np.arange(n[2]) + 0.5) * ext[2] / n[2]
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    # jitter to break lattice symmetry
    pts += rng.uniform(-0.3, 0.3, pts.shape)

    if exclude_positions is not None and len(exclude_positions):
        ex = np.asarray(exclude_positions)
        # min-image distance to any solute atom
        keep = np.ones(len(pts), bool)
        for chunk in range(0, len(pts), 4096):
            d = pts[chunk:chunk + 4096, None, :] - ex[None, :, :]
            d -= box * np.round(d / box)
            r2 = (d * d).sum(-1).min(axis=1)
            keep[chunk:chunk + 4096] = r2 > exclude_radius ** 2
        pts = pts[keep]

    if n_target is not None:
        if len(pts) > n_target:
            sel = rng.choice(len(pts), n_target, replace=False)
            pts = pts[sel]
        elif len(pts) < n_target:
            raise ValueError(
                f"box only fits {len(pts)} waters < requested {n_target}")

    geom = water_geometry(model)
    rots = _random_rotations(len(pts), rng)
    sites = np.einsum("wij,sj->wsi", rots, geom) + pts[:, None, :]
    return sites
