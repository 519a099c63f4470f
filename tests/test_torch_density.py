"""Port parity: molchanica_tpu_torch.density and .sfc_mesh against
molchanica_tpu's, on inputs made with numpy from a seed and on the pocket
fixture's ligand.

Tolerances:
- density_from_atoms: within DENSITY_TOL of max|rho| (the port sums its
  float32 Gaussians over atoms as a matrix product, the reference in a scan
  over atoms; under the test suite's x64 the reference's grid is float64);
- density_map_from_sf: the reciprocal grid bit for bit (the reference's is
  taken at its inverse FFT), the map within DENSITY_TOL of max|rho|;
- sample_density and density_rect: exact on the same map (float64 weights
  on both sides); marching_tetrahedra: exact on the same map;
- molecular_surface: triangles equal, vertices within 1e-5 A.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu import density as JD
from molchanica_tpu import sfc_mesh as JM
from molchanica_tpu_torch import density as TD
from molchanica_tpu_torch import sfc_mesh as TM
from molchanica_tpu_torch.io import read_sdf

torch.set_num_threads(1)

FSDF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "molchanica_tpu", "systems", "data", "pocket_ligand.sdf")

DENSITY_TOL = 1e-5


def _atoms(seed, n, cell):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 3)) * np.asarray(cell), \
        rng.uniform(1.0, 8.0, n)


@pytest.mark.parametrize("case", [
    (0, 40, (16.0, 17.0, 18.0), (24, 26, 28), 15.0),
    (1, 200, (20.0, 20.0, 20.0), (32, 32, 32), 30.0),
])
def test_density_from_atoms(case, monkeypatch):
    """Gaussian atoms on periodic grids (atoms across the faces; the
    second case in two atom chunks)."""
    seed, n, cell, grid, b = case
    pos, z = _atoms(seed, n, cell)
    pos[0] = [0.1, cell[1] - 0.2, 0.05]
    if n > 100:
        monkeypatch.setattr(TD, "ATOM_CHUNK", 128)
    ref = JD.density_from_atoms(pos, z, cell, grid, b_factor=b)
    got = TD.density_from_atoms(pos, z, cell, grid, b_factor=b, device="cpu")
    assert got.data.shape == grid and got.data.dtype == np.float32
    assert got.cell == ref.cell
    np.testing.assert_array_equal(got.origin, ref.origin)
    scale = float(np.abs(ref.data).max())
    np.testing.assert_allclose(got.data, ref.data, rtol=0,
                               atol=DENSITY_TOL * scale)


def _reference_grid(monkeypatch):
    """Records the reciprocal grid the reference hands its inverse FFT."""
    seen = []
    ifftn = jnp.fft.ifftn

    def record(x, *a, **kw):
        seen.append(np.asarray(x))
        return ifftn(x, *a, **kw)
    monkeypatch.setattr(jnp.fft, "ifftn", record)
    return seen


@pytest.mark.parametrize("case", ["amp_phase", "re_im_mates", "full_grid"])
def test_density_map_from_sf(case, monkeypatch):
    """Structure-factor synthesis: random reflections given as amplitude
    and phase (Hermitian mates filled); re / im with duplicate
    reflections, self-mates, mates given explicitly and zero conjugates;
    and every reflection of a grid up to its Nyquist taken from a forward
    FFT, which must give back the map."""
    rng = np.random.default_rng(5)
    seen = _reference_grid(monkeypatch)
    cell = (20.0, 21.0, 22.0)
    if case == "amp_phase":
        h, k, l = (rng.integers(-5, 6, 300) for _ in range(3))
        kw = dict(amp=rng.uniform(0, 3, 300), phase=rng.uniform(0, 6.3, 300))
        re = kw["amp"] * np.cos(kw["phase"])
        im = kw["amp"] * np.sin(kw["phase"])
        grid = None
    elif case == "re_im_mates":
        h = np.array([1, 1, -1, 0, 2, 3, -3, 4, 2, -2])
        k = np.array([0, 0, 0, 0, 1, 1, -1, 0, 1, -1])
        l = np.array([0, 0, 0, 0, 0, 2, -2, 4, 0, 0])
        re = np.array([1.0, 2.0, 0.5, 3.0, 0.0, 1.5, 1.5, 2.0, 0.7, 0.0])
        im = np.array([0.5, 0.1, 0.2, 0.0, 0.0, 0.3, -0.3, 0.0, 0.2, 0.0])
        kw = dict(re=re, im=im)
        grid = (8, 9, 8)
    else:
        grid = (12, 10, 14)
        rho = np.random.default_rng(6).normal(size=grid)
        F = np.fft.fftn(rho) * np.prod(cell) / np.prod(grid)
        idx = np.indices(grid).reshape(3, -1)
        h, k, l = (np.rint(np.fft.fftfreq(n) * n).astype(int)[i]
                   for n, i in zip(grid, idx))
        re, im = F[tuple(idx)].real, F[tuple(idx)].imag
        kw = dict(re=re, im=im)
    ref = JD.density_map_from_sf(h, k, l, grid=grid, cell=cell, **kw)
    F_t = TD.fill_reflections(h, k, l, re, im, ref.data.shape)
    assert len(seen) == 1
    np.testing.assert_array_equal(F_t, seen[0])
    got = TD.density_map_from_sf(h, k, l, grid=grid, cell=cell,
                                 device="cpu", **kw)
    assert got.data.shape == ref.data.shape and got.cell == ref.cell
    scale = float(np.abs(ref.data).max())
    np.testing.assert_allclose(got.data, ref.data, rtol=0,
                               atol=DENSITY_TOL * scale)
    if case == "full_grid":
        np.testing.assert_allclose(got.data, rho, rtol=0,
                                   atol=DENSITY_TOL * np.abs(rho).max())


def test_sample_density_and_rect():
    """Trilinear periodic samples (points inside, outside and on grid
    points) and the crop around atoms, on the reference's own map."""
    rng = np.random.default_rng(2)
    pos, z = _atoms(2, 30, (16.0, 17.0, 18.0))
    dm = JD.density_from_atoms(pos, z, (16.0, 17.0, 18.0), (20, 22, 24))
    dm.origin = np.array([-1.0, 0.5, 2.0])
    on_grid = dm.origin + np.array([[0.0, 0, 0], [4 * 0.8, 0, 0]])
    pts = np.concatenate([rng.uniform(-20, 40, (400, 3)), on_grid])
    got = TD.sample_density(dm, pts, device="cpu")
    np.testing.assert_array_equal(got, JD.sample_density(dm, pts))
    assert got.dtype == np.float64
    for margin in (0.0, 2.0, 5.0):
        a = JD.density_rect(dm, pos[:5] * 0.5 + 3, margin=margin)
        b = TD.density_rect(TD.DensityMap(dm.data, dm.cell, dm.origin),
                            pos[:5] * 0.5 + 3, margin=margin)
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.origin, a.origin)
        assert b.cell == a.cell
    # tests/test_density_mesh.py's trilinear values on the port
    data = np.zeros((8, 8, 8))
    data[4, 4, 4] = 1.0
    d8 = TD.DensityMap(data=data, cell=(8.0, 8.0, 8.0))
    np.testing.assert_allclose(
        TD.sample_density(d8, np.array([[4.0, 4, 4], [4.5, 4, 4]]),
                          device="cpu"), [1.0, 0.5], atol=1e-9)


def test_marching_tetrahedra_and_sphere():
    """The mesher on the reference's map of one Gaussian atom: the
    reference's mesh exactly, and tests/test_density_mesh.py's sphere
    (area within 25% of 4 pi r^2, vertices near r = 2) from the port's
    own map."""
    args = (np.array([[8.0, 8.0, 8.0]]), [6.0])
    kw = dict(cell=(16.0, 16.0, 16.0), grid=(32, 32, 32), b_factor=30.0)
    sig2 = 30.0 / (8 * np.pi ** 2)
    iso = 6.0 / (2 * np.pi * sig2) ** 1.5 * np.exp(-0.5 * 4.0 / sig2)
    dm_j = JD.density_from_atoms(*args, **kw)
    a = JM.marching_tetrahedra(dm_j, float(iso))
    b = TM.marching_tetrahedra(TD.DensityMap(dm_j.data, dm_j.cell),
                               float(iso))
    np.testing.assert_array_equal(b.triangles, a.triangles)
    np.testing.assert_array_equal(b.vertices, a.vertices)
    mesh = TM.marching_tetrahedra(
        TD.density_from_atoms(*args, device="cpu", **kw), float(iso))
    assert mesh.n_triangles > 50
    np.testing.assert_allclose(mesh.area(), 4 * np.pi * 4.0, rtol=0.25)
    r = np.linalg.norm(mesh.vertices - 8.0, axis=1)
    assert abs(r.mean() - 2.0) < 0.2


@pytest.mark.parametrize("case", ["ligand", "random"])
def test_molecular_surface(case):
    """The Gaussian molecular surface of the fixture's ligand (33 atoms,
    0.8 A grid) and of random atoms with radii (0.7 A grid): triangles
    equal, vertices within 1e-5 A; the surface encloses the atoms."""
    if case == "ligand":
        pts = np.asarray(read_sdf(FSDF).positions)
        kw = {}
    else:
        rng = np.random.default_rng(4)
        pts = rng.uniform(0, 8, (12, 3))
        kw = dict(radii=rng.uniform(0.8, 1.6, 12), grid_step=0.7)
    a = JM.molecular_surface(pts, **kw)
    b = TM.molecular_surface(pts, device="cpu", **kw)
    np.testing.assert_array_equal(b.triangles, a.triangles)
    np.testing.assert_allclose(b.vertices, a.vertices, rtol=0, atol=1e-5)
    assert b.n_triangles > 20
    assert np.all(b.vertices.min(0) < pts.min(0))
    assert np.all(b.vertices.max(0) > pts.max(0))
    assert b.area() == pytest.approx(a.area(), rel=1e-6)
