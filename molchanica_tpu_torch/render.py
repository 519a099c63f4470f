"""Headless molecular rendering: scene -> PNG, rasterized in torch.

Port of molchanica_tpu.render (reference parity: the drawing/render/camera
stack, src/drawing/mod.rs entity generation, src/render.rs:32-44 scene
setup, src/cam.rs arc camera with fog, src/drawing/atoms_bonds.rs two-tone
bonds). The host side is the JAX package's, operation for operation and
vectorised: a `Camera` projects world points to view space; every visual
element becomes a depth-tagged primitive (sphere -> disc, bond -> two-tone
segment, ribbon -> spline strip of segments, H-bond and box edge -> dashed
segment); the primitives are sorted back to front, stably, as Python's
`sort(reverse=True)` orders them, and fogged toward the background.

matplotlib's Agg pass is replaced by the port's rasterizer on the scene's
device (None: the CUDA card). It draws what the reference's figure draws
(900 x 700 pixels at 110 dpi, the view fitted to the drawn extents with a
1.08 margin, equal aspect in the square axes box):
- layers: every segment and dashed segment drawn solid with round caps
  (zorder 2), then the discs (zorder 3), then the title, then the dashed
  segments again with matplotlib's "--" pattern and butt caps (zorder 4);
  painter's order inside each layer. H-bonds and box edges are drawn twice,
  as in the reference;
- disc radii in view units, line widths in points (w * dpi / 72 pixels);
  a horizontal or vertical segment snapped to the pixel grid as Agg
  snaps it;
- coverage of a pixel (its center's distance to the shape, a one-pixel
  ramp, capped at the shape's own area for shapes thinner than a pixel);
- alpha compositing in draw order, as one pass over fragments: each
  primitive emits the pixels of its bounding box (long segments in pieces
  of PIECE_PX, each pixel owned by one piece), fragments are sorted by
  (pixel, layer, draw index) and each pixel is composited with the
  segmented product of (1 - alpha) over the fragments drawn after it;
- the title (9 pt DejaVu Sans, #444444, at axes (0.02, 0.98)) from a
  bitmap font kept as data (data/render_font.npz, made by
  scripts/make_render_font.py).
The output is an 8-bit RGB PNG written with zlib and struct. Other
extensions raise ValueError (matplotlib picks a format by extension; the
port writes PNG only, a departure listed in ROADMAP Queue 3). Colors are
'#rrggbb' strings.

    from molchanica_tpu_torch.render import render_molecule
    render_molecule(mol, "mol.png")                    # ball-and-stick
    render_molecule(pep, "pep.png", mode="backbone")   # CA ribbon trace
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device

# CPK-family element colors (public standard scheme, as in the reference's
# atom color tables in src/drawing/atoms_bonds.rs)
CPK_COLORS = {
    "H": "#cfcfcf", "C": "#333333", "N": "#2c59c4", "O": "#d32b2b",
    "F": "#7fc97f", "Cl": "#2ca02c", "Br": "#8c2d04", "I": "#6a3d9a",
    "S": "#d9c52b", "P": "#e67e22", "B": "#f4a582", "Na": "#7b68ee",
    "K": "#8a2be2", "Mg": "#0f9b0f", "Ca": "#888800", "Zn": "#7f7f7f",
    "Fe": "#b7410e", "Se": "#ffa100",
}
DEFAULT_COLOR = "#bc80bd"
CHAIN_COLORS = ["#4472c4", "#ed7d31", "#70ad47", "#9e480e", "#997300",
                "#6f30a0", "#2596be", "#c00000"]

DISC, SEG, DASH = 0, 1, 2
DASHED_PATTERN = (3.7, 1.6)    # matplotlib's "--", in units of line width
TITLE_COLOR = "#444444"
PIECE_PX = 16.0                # longest piece a segment's fragments span
_FONT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "render_font.npz")


def hex_rgb(color: str) -> Tuple[float, float, float]:
    """'#rrggbb' -> RGB in [0, 1] (matplotlib's to_rgb of such a string)."""
    c = color.lstrip("#")
    if len(c) != 6:
        raise ValueError(f"color {color!r}: expected '#rrggbb'")
    return tuple(int(c[i:i + 2], 16) / 255 for i in (0, 2, 4))


def _element_color(el: str) -> str:
    return CPK_COLORS.get(el, DEFAULT_COLOR)


def _display_radius(el: str) -> float:
    from .molecules.elements import VDW_RADII
    return VDW_RADII.get(el, 1.6)


@dataclass
class Camera:
    """Orbit camera (reference arc cam, src/cam.rs): the eye circles a
    target point at `distance`, oriented by azimuth/elevation, with a
    simple perspective divide and linear fog over the depth range."""
    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    distance: float = 30.0
    azimuth_deg: float = 0.0
    elevation_deg: float = 0.0
    fov_deg: float = 35.0          # vertical field of view
    fog: float = 0.45              # 0 = off, 1 = far atoms fade fully

    def rotation(self) -> np.ndarray:
        """World -> view rotation (view looks down -z)."""
        az = math.radians(self.azimuth_deg)
        el = math.radians(self.elevation_deg)
        # yaw about world y, then pitch about camera x
        cy, sy = math.cos(az), math.sin(az)
        cp, sp = math.cos(el), math.sin(el)
        yaw = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
        pitch = np.array([[1.0, 0.0, 0.0], [0.0, cp, sp], [0.0, -sp, cp]])
        return pitch @ yaw

    def view_points(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Project [n,3] world points. Returns ([n,2] screen coords in
        view units, [n] depth with larger = nearer, and the per-point
        perspective scale folded into the coords)."""
        p = (np.atleast_2d(pts) - self.target) @ self.rotation().T
        z = p[:, 2] - self.distance          # eye at +distance on view z
        z = np.minimum(z, -1e-3)             # clamp behind-eye points
        persp = -self.distance / z           # 1 at target plane
        xy = p[:, :2] * persp[:, None]
        return xy, -z

    def scale_at(self, pts: np.ndarray) -> np.ndarray:
        """Perspective size multiplier at each point (1 at target plane)."""
        p = (np.atleast_2d(pts) - self.target) @ self.rotation().T
        z = np.minimum(p[:, 2] - self.distance, -1e-3)
        return -self.distance / z

    def orbit(self, d_azimuth_deg: float = 0.0, d_elevation_deg: float = 0.0):
        self.azimuth_deg = (self.azimuth_deg + d_azimuth_deg) % 360.0
        self.elevation_deg = float(
            np.clip(self.elevation_deg + d_elevation_deg, -89.0, 89.0))

    def zoom(self, factor: float):
        self.distance = float(np.clip(self.distance / max(factor, 1e-6),
                                      1.0, 1e5))

    def snap_to(self, pts: np.ndarray, pad: float = 1.35):
        """Frame a point cloud (reference snap-to-mol, src/cam.rs)."""
        pts = np.atleast_2d(np.asarray(pts, float))
        self.target = pts.mean(axis=0)
        r = float(np.linalg.norm(pts - self.target, axis=1).max()) + 2.0
        half_fov = math.radians(self.fov_deg) / 2.0
        self.distance = max(pad * r / math.tan(half_fov), 5.0)


@dataclass
class RenderStyle:
    """Per-entity draw mode (reference MoleculeView modes)."""
    mode: str = "ball_stick"   # ball_stick | sticks | spheres | backbone | points
    atom_scale: float = 0.22   # fraction of vdW radius (ball_stick)
    bond_width: float = 3.2    # pt at the target plane
    show_hydrogens: bool = True
    color_by: str = "element"  # element | chain | uniform
    color: str = "#777777"     # uniform color
    alpha: float = 1.0
    label: str = ""


@dataclass
class Prims:
    """Primitives as arrays, one row each: kind (DISC, SEG, DASH), depth,
    a (a disc's center or a segment's start, view units), b (a segment's
    end), size (a disc's radius in view units, a segment's width in
    points), rgb (in [0, 1]) and alpha."""
    kind: np.ndarray
    depth: np.ndarray
    a: np.ndarray
    b: np.ndarray
    size: np.ndarray
    rgb: np.ndarray
    alpha: np.ndarray

    def __len__(self):
        return len(self.kind)

    def take(self, idx) -> "Prims":
        return Prims(*(getattr(self, f)[idx] for f in
                       ("kind", "depth", "a", "b", "size", "rgb", "alpha")))


class _PrimList:
    """Chunks of primitives in generation order."""

    def __init__(self):
        self.chunks: List[Prims] = []

    def add(self, kind, depth, a, b, size, rgb, alpha):
        depth = np.asarray(depth, float).reshape(-1)
        n = len(depth)
        if n == 0:
            return
        full = lambda v, shape: np.broadcast_to(
            np.asarray(v, float), shape).astype(float)
        self.chunks.append(Prims(
            np.full(n, kind, np.int64), depth, full(a, (n, 2)),
            full(b, (n, 2)), full(size, (n,)), full(rgb, (n, 3)),
            full(alpha, (n,))))

    def done(self) -> Prims:
        if not self.chunks:
            return Prims(np.zeros(0, np.int64), np.zeros(0), np.zeros((0, 2)),
                         np.zeros((0, 2)), np.zeros(0), np.zeros((0, 3)),
                         np.zeros(0))
        return Prims(*(np.concatenate([getattr(c, f) for c in self.chunks])
                       for f in ("kind", "depth", "a", "b", "size", "rgb",
                                 "alpha")))


class Scene:
    """Collects entities, owns the camera, renders in one pass on
    `device` (None: the CUDA card) (reference: render() scene setup
    src/render.rs:94 + per-class entity generation src/drawing/mod.rs)."""

    def __init__(self, camera: Optional[Camera] = None,
                 background: str = "#ffffff", device=None):
        self.camera = camera or Camera()
        self.background = background
        self.device = device
        self._entities: List[tuple] = []
        self._framed = camera is not None

    # -- entity adders ----------------------------------------------------
    def add_mol(self, mol, style: Optional[RenderStyle] = None):
        """Any MoleculeCommon-like object: .elements, .positions, .bonds,
        optional .atom_names/.chains for backbone mode."""
        self._entities.append(("mol", mol, style or RenderStyle()))

    def add_points(self, pts, color="#5b8dd9", size=2.2, alpha=0.8):
        self._entities.append(("points", np.asarray(pts, float),
                               (color, size, alpha)))

    def add_hbonds(self, segments: Sequence[Tuple[np.ndarray, np.ndarray]],
                   color="#3aa6a6"):
        self._entities.append(("hbonds", list(segments), color))

    def add_box(self, extent, origin=(0.0, 0.0, 0.0), color="#999999"):
        self._entities.append(("box", (np.asarray(origin, float),
                                       np.asarray(extent, float)), color))

    # -- primitive generation ---------------------------------------------
    def _frame_if_needed(self):
        if self._framed:
            return
        pts = []
        for kind, obj, _ in self._entities:
            if kind == "mol":
                pts.append(np.asarray(obj.positions, float))
            elif kind == "points":
                pts.append(obj)
            elif kind == "box":
                o, e = obj
                pts.append(np.stack([o, o + e]))
        if pts:
            self.camera.snap_to(np.concatenate(pts))
            self._framed = True

    def _mol_prims(self, mol, style: RenderStyle, out: _PrimList):
        el = list(mol.elements)
        pos = np.asarray(mol.positions, float)
        keep = np.ones(len(el), bool)
        if not style.show_hydrogens:
            keep = np.array([e != "H" for e in el])
        xy, depth = self.camera.view_points(pos)
        scale = self.camera.scale_at(pos)

        if style.mode == "backbone":
            self._backbone_prims(mol, style, out)
            return
        el_rgb = np.asarray([hex_rgb(_element_color(e)) for e in el],
                            float).reshape(-1, 3)
        if style.mode == "points":
            i = np.nonzero(keep)[0]
            out.add(DISC, depth[i], xy[i], 0.0, 0.12 * scale[i], el_rgb[i],
                    style.alpha)
            return
        rgb = (el_rgb if style.color_by == "element"
               else self._chain_colors(mol, len(el), style))

        # atoms
        r_frac = {"ball_stick": style.atom_scale, "sticks": 0.0,
                  "spheres": 1.0}.get(style.mode, style.atom_scale)
        if r_frac > 0.0:
            i = np.nonzero(keep)[0]
            rad = np.asarray([_display_radius(e) for e in el], float)
            out.add(DISC, depth[i], xy[i], 0.0, r_frac * rad[i] * scale[i],
                    rgb[i], style.alpha)
        # bonds: split at midpoint, each half in its atom's color
        # (reference two-tone bonds, src/drawing/atoms_bonds.rs)
        bonds = np.asarray(list(getattr(mol, "bonds", []) or []),
                           np.int64).reshape(-1, 2)
        bonds = bonds[keep[bonds[:, 0]] & keep[bonds[:, 1]]]
        if len(bonds) == 0:
            return
        i, j = bonds[:, 0], bonds[:, 1]
        mid_xy = 0.5 * (xy[i] + xy[j])
        mid_d = 0.5 * (depth[i] + depth[j])
        w = style.bond_width * 0.5 * (scale[i] + scale[j])
        ab = np.stack([i, j], axis=1).reshape(-1)      # i-half, j-half
        rep = lambda v: np.repeat(v, 2, axis=0)
        out.add(SEG, 0.5 * (depth[ab] + rep(mid_d)), xy[ab], rep(mid_xy),
                rep(w), rgb[ab], style.alpha)

    def _chain_colors(self, mol, n, style: RenderStyle) -> np.ndarray:
        chains = getattr(mol, "chains", None)
        if style.color_by == "uniform" or not chains:
            return np.tile(hex_rgb(style.color), (n, 1))
        uniq = sorted(set(chains))
        return np.asarray([hex_rgb(CHAIN_COLORS[uniq.index(c)
                                                % len(CHAIN_COLORS)])
                           for c in chains[:n]], float)

    def _backbone_prims(self, mol, style: RenderStyle, out: _PrimList):
        """CA trace as a Catmull-Rom resampled strip per chain (the
        headless stand-in for the reference ribbon mesh,
        src/drawing/ribbon_mesh.rs)."""
        names = getattr(mol, "atom_names", None)
        if names is None:
            return
        chains = getattr(mol, "chains", None) or ["A"] * len(names)
        pos = np.asarray(mol.positions, float)
        for chain in sorted(set(chains)):
            idx = [i for i, (n, c) in enumerate(zip(names, chains))
                   if n == "CA" and c == chain]
            if len(idx) < 2:
                continue
            pts = _catmull_rom(pos[idx], per_seg=8)
            xy, depth = self.camera.view_points(pts)
            scale = self.camera.scale_at(pts)
            color = (style.color if style.color_by == "uniform" else
                     CHAIN_COLORS[sorted(set(chains)).index(chain)
                                  % len(CHAIN_COLORS)])
            w = 3.2 * style.bond_width * 0.5 * (scale[:-1] + scale[1:])
            out.add(SEG, 0.5 * (depth[:-1] + depth[1:]), xy[:-1], xy[1:], w,
                    hex_rgb(color), style.alpha)

    def primitives(self) -> Prims:
        """Every primitive in draw order (far first; equal depths in
        generation order) with its fogged color: what the reference hands
        to matplotlib."""
        self._frame_if_needed()
        out = _PrimList()
        for kind, obj, extra in self._entities:
            if kind == "mol":
                self._mol_prims(obj, extra, out)
            elif kind == "points":
                color, sz, alpha = extra
                xy, depth = self.camera.view_points(obj)
                scale = self.camera.scale_at(obj)
                out.add(DISC, depth, xy, 0.0, 0.06 * sz * scale,
                        hex_rgb(color), alpha)
            elif kind == "hbonds" and obj:
                a = np.stack([np.asarray(s[0], float) for s in obj])
                b = np.stack([np.asarray(s[1], float) for s in obj])
                xa, da = self.camera.view_points(a)
                xb, db = self.camera.view_points(b)
                out.add(DASH, (da + db) / 2, xa, xb, 1.4, hex_rgb(extra), 0.9)
            elif kind == "box":
                (o, e) = obj
                corners = np.array([[o[0] + dx * e[0], o[1] + dy * e[1],
                                     o[2] + dz * e[2]]
                                    for dx in (0, 1) for dy in (0, 1)
                                    for dz in (0, 1)])
                edges = np.array([(0, 1), (0, 2), (0, 4), (3, 1), (3, 2),
                                  (3, 7), (5, 1), (5, 4), (5, 7), (6, 2),
                                  (6, 4), (6, 7)])
                xy, depth = self.camera.view_points(corners)
                out.add(DASH, np.minimum(depth[edges[:, 0]],
                                         depth[edges[:, 1]]),
                        xy[edges[:, 0]], xy[edges[:, 1]], 0.8,
                        hex_rgb(extra), 0.6)
        p = out.done()
        if len(p) == 0:
            raise ValueError("empty scene")
        p = p.take(np.argsort(-p.depth, kind="stable"))     # far first
        dmin, dmax = p.depth.min(), p.depth.max()
        drange = max(dmax - dmin, 1e-9)
        # linear depth cue toward the background (reference fog)
        t = (self.camera.fog * (p.depth - dmin) / drange)[:, None]
        p.rgb = (1 - t) * p.rgb + t * np.asarray(hex_rgb(self.background))
        return p

    # -- rasterization -----------------------------------------------------
    def rasterize(self, size: Tuple[int, int] = (900, 700), dpi: int = 110,
                  title: str = "") -> torch.Tensor:
        """The scene as an [H, W, 3] uint8 tensor on the scene's device."""
        return rasterize(self.primitives(), size, dpi, title,
                         self.background, self.device)

    def render(self, path: str, size: Tuple[int, int] = (900, 700),
               dpi: int = 110, title: str = ""):
        """Depth-sort all primitives back-to-front and draw once; write
        an 8-bit RGB PNG."""
        if not str(path).lower().endswith(".png"):
            raise ValueError(f"{path}: the port's renderer writes PNG only")
        img = self.rasterize(size, dpi, title)
        write_png(path, img.cpu().numpy())
        return path


def _catmull_rom(pts: np.ndarray, per_seg: int = 8) -> np.ndarray:
    """Centripetal-flavored Catmull-Rom resampling of a polyline."""
    pts = np.asarray(pts, float)
    if len(pts) < 3:
        return pts
    p = np.concatenate([pts[:1], pts, pts[-1:]])
    out = []
    ts = np.linspace(0.0, 1.0, per_seg, endpoint=False)
    for i in range(len(pts) - 1):
        p0, p1, p2, p3 = p[i], p[i + 1], p[i + 2], p[i + 3]
        for t in ts:
            t2, t3 = t * t, t * t * t
            out.append(0.5 * ((2 * p1) + (-p0 + p2) * t
                              + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                              + (-p0 + 3 * p1 - 3 * p2 + p3) * t3))
    out.append(pts[-1])
    return np.asarray(out)


# -- the rasterizer -------------------------------------------------------

def view_fit(p: Prims) -> Tuple[np.ndarray, float]:
    """(center, half side) of the square view: the drawn extents (segment
    ends, disc edges) with the reference's 1.08 margin."""
    seg = p.kind != DISC
    disc = ~seg
    lo = np.minimum(np.min(np.concatenate([p.a[seg], p.b[seg]]), axis=0,
                           initial=np.inf),
                    np.min(p.a[disc] - p.size[disc, None], axis=0,
                           initial=np.inf))
    hi = np.maximum(np.max(np.concatenate([p.a[seg], p.b[seg]]), axis=0,
                           initial=-np.inf),
                    np.max(p.a[disc] + p.size[disc, None], axis=0,
                           initial=-np.inf))
    return (lo + hi) / 2, (hi - lo).max() / 2 * 1.08 + 1e-6


def _pieces(c0, c1, ext, W, H):
    """Pixel boxes [col0, col1] x [row0, row1] around the span c0 -> c1
    (pixel coordinates, centers at +0.5) widened by `ext`, clipped to the
    image; counts of their pixels (0 for an empty box)."""
    lo = torch.minimum(c0, c1) - ext[:, None]
    hi = torch.maximum(c0, c1) + ext[:, None]
    col0 = torch.clamp(torch.ceil(lo[:, 0] - 0.5), min=0).long()
    col1 = torch.clamp(torch.floor(hi[:, 0] - 0.5), max=W - 1).long()
    row0 = torch.clamp(torch.ceil(lo[:, 1] - 0.5), min=0).long()
    row1 = torch.clamp(torch.floor(hi[:, 1] - 0.5), max=H - 1).long()
    nx = torch.clamp(col1 - col0 + 1, min=0)
    ny = torch.clamp(row1 - row0 + 1, min=0)
    return col0, row0, nx, nx * ny


def _expand(col0, row0, nx, cnt):
    """One fragment per pixel of each box: (box index, pixel x, pixel y)
    with pixel centers."""
    dev = cnt.device
    owner = torch.repeat_interleave(torch.arange(len(cnt), device=dev), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(len(owner), device=dev) - start[owner]
    n = nx[owner]
    px = (col0[owner] + local % n).double() + 0.5
    py = (row0[owner] + local // n).double() + 0.5
    return owner, px, py


def _ramp(half, dist):
    """Pixel coverage by a shape whose edge lies `half` from its axis at
    distance `dist` from the pixel center: a one-pixel ramp, capped at the
    area of a shape thinner than a pixel."""
    return torch.minimum(torch.clamp(half + 0.5 - dist, 0.0, 1.0),
                         torch.clamp(2.0 * half, max=1.0))


def _disc_fragments(c, r, W, H):
    col0, row0, nx, cnt = _pieces(c, c, r + 0.5, W, H)
    k, px, py = _expand(col0, row0, nx, cnt)
    d = torch.hypot(px - c[k, 0], py - c[k, 1])
    rk = r[k]
    cov = torch.minimum(torch.clamp(rk + 0.5 - d, 0.0, 1.0),
                        torch.clamp(math.pi * rk * rk, max=1.0))
    return k, px, py, cov


def _segment_fragments(p0, p1, half, dash, W, H):
    """Fragments of segments p0 -> p1 of half-width `half` (pixels): round
    caps, or with dash = (on, off) lengths the dashed pattern with butt
    caps. Segments are cut into pieces of at most PIECE_PX; a pixel
    belongs to the piece that holds its projection onto the segment."""
    dev = p0.device
    vec = p1 - p0
    length = torch.linalg.norm(vec, dim=1)
    n_pc = torch.clamp(torch.ceil(length / PIECE_PX), min=1).long()
    seg = torch.repeat_interleave(torch.arange(len(n_pc), device=dev), n_pc)
    kk = (torch.arange(len(seg), device=dev)
          - (torch.cumsum(n_pc, 0) - n_pc)[seg]).double()
    s0 = kk * length[seg] / n_pc[seg]
    s1 = (kk + 1) * length[seg] / n_pc[seg]
    u = vec / torch.clamp(length, min=1e-12)[:, None]
    q0 = p0[seg] + s0[:, None] * u[seg]
    q1 = p0[seg] + s1[:, None] * u[seg]
    col0, row0, nx, cnt = _pieces(q0, q1, half[seg] + 0.5, W, H)
    pc, px, py = _expand(col0, row0, nx, cnt)
    k = seg[pc]
    rx, ry = px - p0[k, 0], py - p0[k, 1]
    s = rx * u[k, 0] + ry * u[k, 1]
    L = length[k]
    sc = torch.minimum(torch.clamp(s, min=0.0), L)
    first = kk[pc] == 0
    last = kk[pc] == (n_pc[k] - 1).double()
    own = ((first | (sc >= s0[pc])) & (last | (sc < s1[pc])))
    hk = half[k]
    if dash is None:
        d = torch.hypot(rx - sc * u[k, 0], ry - sc * u[k, 1])
        cov = _ramp(hk, d)
    else:
        on, off = dash[0][k], dash[1][k]
        d = torch.abs(rx * u[k, 1] - ry * u[k, 0])
        ph = torch.remainder(s, on + off)
        inside = torch.where(ph < on, torch.minimum(ph, on - ph),
                             -torch.minimum(ph - on, on + off - ph))
        inside = torch.minimum(inside, torch.minimum(s, L - s))
        cov = _ramp(hk, d) * torch.clamp(inside + 0.5, 0.0, 1.0)
    return k, px, py, torch.where(own, cov, torch.zeros_like(cov))


_FONT = None


def _font():
    global _FONT
    if _FONT is None:
        with np.load(_FONT_PATH, allow_pickle=False) as z:
            _FONT = {k: z[k] for k in z.files}
    return _FONT


def title_coverage(title: str, W: int, H: int, dpi: int):
    """(rows, cols, coverage in [0, 1]) of the title's pixels: glyphs
    placed from the anchor at axes (0.02, 0.98) along FreeType's pen
    advances (whole pixels: FreeType renders each glyph at its subpixel
    pen position, so edge pixels differ), overlapping glyph pixels merged
    by their maximum as matplotlib merges its glyph bitmaps."""
    f = _font()
    k = dpi / float(f["dpi"])
    first, n = int(f["first"]), len(f["row"])
    codes = [ord(ch) - first if 0 <= ord(ch) - first < n
             else ord("?") - first for ch in title]
    side = min(W, H)
    ax_x = (W - side) / 2 + 0.02 * side
    ax_top = H - ((H - side) / 2 + 0.98 * side)
    canvas = {}
    pen = 0.0
    for m, c in enumerate(codes):
        h, w = int(f["height"][c]), int(f["width"][c])
        if h and w:
            bm = f["bitmaps"][c, :h, :w]
            if k != 1.0:    # another dpi: nearest-neighbour resampling
                ri = (np.arange(max(1, round(h * k))) / k).astype(int)
                ci = (np.arange(max(1, round(w * k))) / k).astype(int)
                bm = bm[np.minimum(ri, h - 1)][:, np.minimum(ci, w - 1)]
            r0 = int(round(ax_top + f["row"][c] * k))
            c0 = int(round(ax_x + f["col"][c] * k) + math.floor(pen))
            for (i, j), v in np.ndenumerate(bm):
                if v:
                    key = (r0 + i, c0 + j)
                    canvas[key] = max(canvas.get(key, 0), int(v))
        if m + 1 < len(codes):
            pen += f["pair_advance_64"][c, codes[m + 1]] / 64.0 * k
    keys = [(r, c) for (r, c) in canvas if 0 <= r < H and 0 <= c < W]
    rows = np.asarray([r for r, _ in keys], np.int64)
    cols = np.asarray([c for _, c in keys], np.int64)
    cov = np.asarray([canvas[key] / 255.0 for key in keys], float)
    return rows, cols, cov


def rasterize(p: Prims, size=(900, 700), dpi: int = 110, title: str = "",
              background: str = "#ffffff", device=None,
              stats: Optional[dict] = None) -> torch.Tensor:
    """Draw primitives in draw order (see the module docstring) into an
    [H, W, 3] uint8 tensor on `device` (None: the CUDA card). Fragment
    generation, the sort and the compositing run there as whole-array
    operations. `stats`, when given, receives the count of fragments
    composited."""
    W, H = int(size[0]), int(size[1])
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    center, half = view_fit(p)
    side = min(W, H)
    px_per = side / (2.0 * half)
    org = np.array([(W - side) / 2.0, (H - side) / 2.0])
    # view units -> pixel coordinates (x right, y down from the top row)
    to_px = lambda xy: np.stack(
        [org[0] + (xy[:, 0] - (center[0] - half)) * px_per,
         H - (org[1] + (xy[:, 1] - (center[1] - half)) * px_per)], axis=1)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f64)
    N = len(p)
    a_px, b_px = T(to_px(p.a)), T(to_px(p.b))
    kind = torch.as_tensor(p.kind, device=dev)
    rgb, alpha = T(p.rgb), T(p.alpha)
    lw_half = T(p.size * dpi / 72.0 / 2.0)
    # Agg snaps a horizontal or vertical segment's ends to pixel centers
    # (odd rounded width) or pixel corners (even)
    flat = ((torch.abs(a_px - b_px) < 1e-4).any(dim=1)
            & (kind != DISC))[:, None]
    snap = torch.remainder(torch.floor(2.0 * lw_half + 0.5), 2.0)[:, None] / 2
    a_px = torch.where(flat, torch.floor(a_px + 0.5) + snap, a_px)
    b_px = torch.where(flat, torch.floor(b_px + 0.5) + snap, b_px)
    frags = []      # (pixel, sort key, alpha, rgb) per layer

    def emit(layer, idx, k, px, py, cov):
        keep = cov > 0
        k, cov = k[keep], cov[keep]
        pix = (py[keep].long() * W + px[keep].long())
        prim = idx[k]
        frags.append((pix, pix * (4 * N) + layer * N + prim,
                      cov * alpha[prim], rgb[prim]))

    segs = torch.nonzero(kind != DISC).reshape(-1)
    discs = torch.nonzero(kind == DISC).reshape(-1)
    dashes = torch.nonzero(kind == DASH).reshape(-1)
    if len(segs):       # zorder 2: every segment solid, round caps
        emit(0, segs, *_segment_fragments(a_px[segs], b_px[segs],
                                          lw_half[segs], None, W, H))
    if len(discs):      # zorder 3: the discs
        emit(1, discs, *_disc_fragments(a_px[discs],
                                        T(p.size * px_per)[discs], W, H))
    if title:           # the title's text, after the discs
        rows, cols, cov = title_coverage(title, W, H, dpi)
        pix = torch.as_tensor(rows * W + cols, device=dev)
        frags.append((pix, pix * (4 * N) + 2 * N,
                      T(cov), T(hex_rgb(TITLE_COLOR)).expand(len(cov), 3)))
    if len(dashes):     # zorder 4: the dashed segments again, "--"
        lw = 2.0 * lw_half[dashes]
        dash = tuple(v * lw for v in DASHED_PATTERN)
        emit(3, dashes, *_segment_fragments(a_px[dashes], b_px[dashes],
                                            lw_half[dashes], dash, W, H))
    pix = torch.cat([f[0] for f in frags])
    key = torch.cat([f[1] for f in frags])
    a = torch.cat([f[2] for f in frags])
    col = torch.cat([f[3] for f in frags])
    if stats is not None:
        stats["fragments"] = len(key)
    key, perm = torch.sort(key)
    pix, a, col = pix[perm], a[perm], col[perm]
    # each pixel's fragments are contiguous now, in draw order; a
    # fragment's weight is its alpha times the transmittance of the
    # fragments drawn after it: exp of the segmented sum of log(1 - a)
    lg = torch.log(torch.clamp(1.0 - a, min=1e-30))
    csum = torch.cumsum(lg, 0)
    new = torch.ones(len(pix), dtype=torch.bool, device=dev)
    new[1:] = pix[1:] != pix[:-1]
    seg = torch.cumsum(new.long(), 0) - 1
    starts = torch.nonzero(new).reshape(-1)
    ends = torch.cat([starts[1:] - 1, torch.full_like(starts[:1],
                                                      len(pix) - 1)])
    base = torch.where(starts > 0, csum[torch.clamp(starts - 1, min=0)],
                       torch.zeros_like(csum[starts]))
    w = a * torch.exp(csum[ends][seg] - csum)
    bg = T(hex_rgb(background))
    img = bg.repeat(W * H, 1)
    img[pix[starts]] = torch.exp(csum[ends] - base)[:, None] * bg
    img = img.index_add_(0, pix, col * w[:, None])
    out = torch.clamp(torch.floor(img * 255.0 + 0.5), 0, 255)
    return out.to(torch.uint8).reshape(H, W, 3)


def write_png(path: str, rgb: np.ndarray) -> str:
    """An [H, W, 3] uint8 array as an 8-bit RGB PNG (filter 0 rows)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError("write_png takes [H, W, 3] uint8")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))
    return path


# -- convenience entry points ---------------------------------------------

def render_molecule(mol, path: str, mode: str = "ball_stick",
                    camera: Optional[Camera] = None, size=(900, 700),
                    show_hydrogens: bool = True, title: str = "",
                    color_by: str = "element", device=None) -> str:
    """One molecule to one image (the common case)."""
    sc = Scene(camera=camera, device=device)
    sc.add_mol(mol, RenderStyle(mode=mode, show_hydrogens=show_hydrogens,
                                color_by=color_by))
    return sc.render(path, size=size, title=title or getattr(mol, "name", ""))


def snapshot_scene(snap, elements: Sequence[str], bonds=None,
                   camera: Optional[Camera] = None, device=None) -> Scene:
    """The Scene of one trajectory frame (render_snapshot's)."""
    from .molecules.common import MoleculeCommon
    mol = MoleculeCommon(elements=list(elements),
                         positions=np.asarray(snap.atom_posits, float),
                         bonds=list(bonds) if bonds is not None else [])
    sc = Scene(camera=camera, device=device)
    sc.add_mol(mol, RenderStyle())
    if snap.water_o_posits is not None and len(snap.water_o_posits):
        sc.add_points(snap.water_o_posits, color="#c23b3b", size=1.6)
        if snap.water_h0_posits is not None:
            sc.add_points(snap.water_h0_posits, color="#bbbbbb", size=0.9)
            sc.add_points(snap.water_h1_posits, color="#bbbbbb", size=0.9)
    if getattr(snap, "hydrogen_bonds", None):
        segs = []
        for hb in snap.hydrogen_bonds:
            d = getattr(hb, "donor_posit", None)
            a = getattr(hb, "acceptor_posit", None)
            if d is not None and a is not None:
                segs.append((d, a))
        if segs:
            sc.add_hbonds(segs)
    if getattr(snap, "box_extent", None) is not None:
        sc.add_box(snap.box_extent)
    return sc


def snapshot_title(snap, title: str = "") -> str:
    return title or (f"t = {snap.time:.2f} ps" if snap.time is not None
                     else "")


def render_snapshot(snap, elements: Sequence[str], path: str,
                    bonds=None, camera: Optional[Camera] = None,
                    size=(900, 700), title: str = "", device=None) -> str:
    """One trajectory frame: solute ball-and-stick + split water arrays as
    points + recorded H-bonds as dashed segments (what the reference viewer
    draws per frame, src/md/viewer.rs:963 draw_mols)."""
    sc = snapshot_scene(snap, elements, bonds, camera, device)
    return sc.render(path, size=size, title=snapshot_title(snap, title))
