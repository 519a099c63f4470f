"""Electron density: structure-factor synthesis + map sampling (port of
molchanica_tpu.density).

Reference parity: src/reflection.rs — density_map_from_sf (reciprocal-grid
fill from Miller indices + inverse FFT, :564), DensityRect atom-region
cropping (:126) and the make_densities kernel (:243) which samples density
at points near atoms.

The synthesis is torch.fft.ifftn on the device, point sampling a trilinear
gather on the device, and the Gaussian-atom model a sum over atoms on the
device: per atom and axis a [n] Gaussian factor (made in float64), the
products summed over chunks of atoms as one float32 matrix product per
chunk (the reference runs a scan over atoms, so the float32 sums run in
another order). The crop stays numpy on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device

# atoms per chunk of density_from_atoms: the chunk's [atoms, nx * ny]
# products take 4 bytes each (96^2 points: 36 KB per atom)
ATOM_CHUNK = 1024


@dataclass
class DensityMap:
    """Real-space density on a periodic grid (reference DensityMap)."""
    data: np.ndarray                 # [nx, ny, nz] x-fast logical order
    cell: Tuple[float, float, float] # orthorhombic cell lengths (A)
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def dims(self):
        return self.data.shape

    @property
    def step(self):
        return np.asarray(self.cell) / np.asarray(self.data.shape)


def fill_reflections(h, k, l, re, im, grid) -> np.ndarray:
    """The complex64 reciprocal grid of the reflections: each at (h, k, l)
    mod grid, and its Hermitian mate at (-h, -k, -l) set to the conjugate
    where that cell differs and is still zero. The reference fills the
    mates in a loop over the reflections in order, where a mate cell set
    by an earlier reflection is no longer zero; here the first reflection
    of each such cell sets it (a conjugate of zero sets nothing, so the
    first with a nonzero conjugate)."""
    nx, ny, nz = grid
    F = np.zeros(grid, np.complex64)
    u, v, w = h % nx, k % ny, l % nz
    F[u, v, w] = np.asarray(re) + 1j * np.asarray(im)
    u2, v2, w2 = (-h) % nx, (-k) % ny, (-l) % nz
    conj = np.empty(len(h), np.complex128)
    conj.real = np.asarray(re, np.float64)
    conj.imag = -np.asarray(im, np.float64)
    conj = conj.astype(np.complex64)
    own = (u2 == u) & (v2 == v) & (w2 == w)
    cand = np.nonzero(~own & (F[u2, v2, w2] == 0) & (conj != 0))[0]
    flat = np.ravel_multi_index((u2[cand], v2[cand], w2[cand]), grid)
    _, first = np.unique(flat, return_index=True)
    pick = cand[first]
    F[u2[pick], v2[pick], w2[pick]] = conj[pick]
    return F


def density_map_from_sf(h, k, l, amp=None, phase=None, re=None, im=None,
                        grid: Tuple[int, int, int] = None,
                        cell=(50.0, 50.0, 50.0), device=None) -> DensityMap:
    """Synthesize a density map from structure factors
    (reference density_map_from_sf, reflection.rs:564) on `device` (None:
    the CUDA card).

    Provide either (amp, phase[rad]) or (re, im) per reflection. Hermitian
    mates are filled automatically so the synthesis is real.
    """
    dev = resolve_device(device)
    h = np.asarray(h, int)
    k = np.asarray(k, int)
    l = np.asarray(l, int)
    if re is None:
        re = np.asarray(amp) * np.cos(np.asarray(phase))
        im = np.asarray(amp) * np.sin(np.asarray(phase))
    if grid is None:
        n = int(2 * max(np.abs(h).max(), np.abs(k).max(),
                        np.abs(l).max()) + 2)
        grid = (n, n, n)
    F = fill_reflections(h, k, l, re, im, tuple(grid))
    rho = torch.fft.ifftn(torch.as_tensor(F, device=dev)).real.cpu().numpy()
    # scale: ifftn already divides by N (numpy convention) — the map is
    # in (sum F)/V-style units; normalize to unit cell volume
    vol = float(np.prod(cell))
    return DensityMap(data=rho * np.prod(grid) / vol, cell=tuple(cell))


def sample_density(dmap: DensityMap, points: np.ndarray,
                   device=None) -> np.ndarray:
    """Trilinear periodic interpolation at Cartesian points — the
    make_densities analog (reflection.rs:243) as one gather on `device`
    (None: the CUDA card). Fractional coordinates and weights in float64."""
    dev = resolve_device(device)
    pts = (np.asarray(points, float) - dmap.origin) / dmap.step
    nx, ny, nz = dmap.dims
    data = torch.tensor(np.asarray(dmap.data), device=dev)

    f = torch.as_tensor(pts, device=dev)
    i0 = torch.floor(f).long()
    t = f - i0

    def at(di, dj, dk):
        return data[(i0[:, 0] + di) % nx, (i0[:, 1] + dj) % ny,
                    (i0[:, 2] + dk) % nz]

    c = 0.0
    for di in (0, 1):
        wx = (1 - t[:, 0]) if di == 0 else t[:, 0]
        for dj in (0, 1):
            wy = (1 - t[:, 1]) if dj == 0 else t[:, 1]
            for dk in (0, 1):
                wz = (1 - t[:, 2]) if dk == 0 else t[:, 2]
                c = c + wx * wy * wz * at(di, dj, dk)
    return c.cpu().numpy()


def density_rect(dmap: DensityMap, atom_posits: np.ndarray,
                 margin: float = 2.0) -> DensityMap:
    """Crop the smallest brick covering all atoms + margin
    (reference DensityRect::new, reflection.rs:142)."""
    pts = np.asarray(atom_posits, float)
    lo = pts.min(axis=0) - margin
    hi = pts.max(axis=0) + margin
    step = dmap.step
    i_lo = np.floor((lo - dmap.origin) / step).astype(int)
    i_hi = np.ceil((hi - dmap.origin) / step).astype(int) + 1
    dims = np.asarray(dmap.dims)
    idx = [np.arange(i_lo[d], i_hi[d]) % dims[d] for d in range(3)]
    sub = dmap.data[np.ix_(idx[0], idx[1], idx[2])]
    return DensityMap(
        data=sub,
        cell=tuple((i_hi - i_lo) * step),
        origin=dmap.origin + i_lo * step)


def density_from_atoms(positions: np.ndarray, numbers: Sequence[float],
                       cell, grid: Tuple[int, int, int],
                       b_factor: float = 15.0, device=None) -> DensityMap:
    """Gaussian-atom model density on a periodic grid (used for synthetic
    maps, map cross-correlation, and the surface mesher), a float32 map
    made on `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    nx, ny, nz = grid
    cell = np.asarray(cell, float)
    f32 = dict(dtype=torch.float32, device=dev)
    # positions rounded to float32 as the reference rounds them; each
    # atom's [n] factors in float64 (float32 would round a tail factor
    # exp(-x) to within x eps of itself), their products in float32
    pos = torch.as_tensor(np.asarray(positions, np.float32),
                          device=dev).double()
    z = torch.as_tensor(np.asarray(numbers, np.float32), device=dev)
    sig2 = b_factor / (8.0 * np.pi ** 2)

    def axis_factors(n, d):
        # [atoms, n]: each atom's minimum-image Gaussian along axis d
        g = (torch.arange(n, dtype=torch.float64, device=dev) + 0.5) \
            * float(cell[d] / n)
        dx = g[None, :] - pos[:, d, None]
        dx = dx - float(cell[d]) * torch.round(dx / float(cell[d]))
        return torch.exp(-0.5 * dx * dx / sig2).float()

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        ex = z[:, None] * axis_factors(nx, 0)
        ey, ez = axis_factors(ny, 1), axis_factors(nz, 2)
        rho = torch.zeros(nx * ny, nz, **f32)
        for a in range(0, len(z), ATOM_CHUNK):
            b = a + ATOM_CHUNK
            exy = (ex[a:b, :, None] * ey[a:b, None, :]).reshape(-1, nx * ny)
            rho += exy.T @ ez[a:b]
        rho = rho.reshape(nx, ny, nz) / (2 * np.pi * sig2) ** 1.5
    return DensityMap(data=rho.cpu().numpy(), cell=tuple(cell))
