"""Isosurface meshes: marching tetrahedra over density grids (port of
molchanica_tpu.sfc_mesh: the mesher is the reference's host loop over
voxels, unchanged; the density under a molecular surface comes from
density_from_atoms on the device).

Reference parity: the sfc_mesh surface layer + make_density_mesh
(src/reflection.rs:454) — triangle meshes of electron-density isosurfaces
and gaussian molecular surfaces. Marching tetrahedra (each voxel split
into 6 tets; each tet has trivially enumerable crossing cases) rather
than table-driven marching cubes: no 256-case tables, same watertight
output.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .density import DensityMap, density_from_atoms

# the 6 tetrahedra of a cube (vertex ids 0..7 = corner bit codes x+2y+4z)
_CUBE_TETS = [
    (0, 5, 1, 3), (0, 5, 3, 7), (0, 5, 7, 4),
    (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7),
]
_CORNER = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])


@dataclass
class SurfaceMesh:
    vertices: np.ndarray     # [V, 3]
    triangles: np.ndarray    # [T, 3] int

    @property
    def n_triangles(self):
        return len(self.triangles)

    def area(self) -> float:
        v = self.vertices
        t = self.triangles
        a = v[t[:, 1]] - v[t[:, 0]]
        b = v[t[:, 2]] - v[t[:, 0]]
        return float(0.5 * np.linalg.norm(np.cross(a, b), axis=1).sum())


def marching_tetrahedra(dmap: DensityMap, iso: float) -> SurfaceMesh:
    """Extract the iso-surface triangle mesh."""
    data = np.asarray(dmap.data, float)
    nx, ny, nz = data.shape
    step = dmap.step
    verts = []
    tris = []
    vid = {}

    def edge_vertex(pa, pb, va, vb):
        key = (pa, pb) if pa < pb else (pb, pa)
        if key in vid:
            return vid[key]
        a = np.asarray(pa, float)
        b = np.asarray(pb, float)
        t = (iso - va) / (vb - va) if vb != va else 0.5
        p = dmap.origin + (a + t * (b - a) + 0.5) * step
        vid[key] = len(verts)
        verts.append(p)
        return vid[key]

    # iterate interior cubes (non-periodic mesh)
    for ix in range(nx - 1):
        for iy in range(ny - 1):
            for iz in range(nz - 1):
                cv = [data[ix + c[0], iy + c[1], iz + c[2]]
                      for c in _CORNER]
                if max(cv) < iso or min(cv) >= iso:
                    continue
                base = (ix, iy, iz)
                for tet in _CUBE_TETS:
                    vals = [cv[t] for t in tet]
                    pts = [tuple(np.asarray(base) + _CORNER[t])
                           for t in tet]
                    inside = [v >= iso for v in vals]
                    n_in = sum(inside)
                    if n_in in (0, 4):
                        continue
                    ins = [i for i in range(4) if inside[i]]
                    outs = [i for i in range(4) if not inside[i]]
                    if n_in == 1:
                        i0 = ins[0]
                        e = [edge_vertex(pts[i0], pts[o], vals[i0],
                                         vals[o]) for o in outs]
                        tris.append(e)
                    elif n_in == 3:
                        o0 = outs[0]
                        e = [edge_vertex(pts[i], pts[o0], vals[i],
                                         vals[o0]) for i in ins]
                        tris.append(e[::-1])
                    else:   # 2-2: quad -> two triangles
                        i0, i1 = ins
                        o0, o1 = outs
                        a = edge_vertex(pts[i0], pts[o0], vals[i0], vals[o0])
                        b = edge_vertex(pts[i0], pts[o1], vals[i0], vals[o1])
                        c = edge_vertex(pts[i1], pts[o1], vals[i1], vals[o1])
                        d = edge_vertex(pts[i1], pts[o0], vals[i1], vals[o0])
                        tris.append([a, b, c])
                        tris.append([a, c, d])
    if not verts:
        return SurfaceMesh(np.zeros((0, 3)), np.zeros((0, 3), int))
    return SurfaceMesh(np.asarray(verts), np.asarray(tris, int))


def molecular_surface(positions: np.ndarray, radii=None,
                      grid_step: float = 0.8, iso: float = 0.4,
                      margin: float = 4.0, device=None) -> SurfaceMesh:
    """Gaussian molecular surface of an atom set (sfc_mesh analog); its
    density on `device` (None: the CUDA card)."""
    pts = np.asarray(positions, float)
    lo = pts.min(axis=0) - margin
    hi = pts.max(axis=0) + margin
    cell = hi - lo
    grid = tuple(max(int(c / grid_step), 8) for c in cell)
    z = np.ones(len(pts)) if radii is None else np.asarray(radii)
    dmap = density_from_atoms(pts - lo, z, cell, grid, b_factor=25.0,
                              device=device)
    dmap.origin = lo
    return marching_tetrahedra(dmap, iso * float(dmap.data.max()))
