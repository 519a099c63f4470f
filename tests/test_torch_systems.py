"""Port parity: system builders, topology, config and small host pieces of
molchanica_tpu_torch against molchanica_tpu on the CPU.

Tolerances: integer fields equal; float fields within 1e-6 (both sides
round the same float64 values to float32, so they agree exactly in
practice).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from molchanica_tpu.ops.nonbonded import intramol_pairs_np as j_intramol
from molchanica_tpu.ops.pbc import minimum_image as j_mi
from molchanica_tpu.ops.pbc import wrap as j_wrap
from molchanica_tpu.systems.bench_systems import \
    build_solvated_protein as j_build
from molchanica_tpu_torch.ops.nonbonded import intramol_pairs_np
from molchanica_tpu_torch.ops.pbc import minimum_image, wrap
from molchanica_tpu_torch.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           make_topology,
                                           topology_from_numpy)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def systems():
    kw = dict(n_residues=8, box_side=24.0, seed=3)
    return j_build(**kw), build_solvated_protein(**kw)


def _assert_field(name, ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    assert ref.shape == got.shape, name
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref.astype(np.float32), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("field", TENSOR_FIELDS)
def test_builder_topology_fields(systems, field):
    j_sys, t_sys = systems
    _assert_field(field, getattr(j_sys.topology, field),
                  getattr(t_sys.topology, field))


def test_builder_positions_and_statics(systems):
    j_sys, t_sys = systems
    np.testing.assert_allclose(t_sys.positions, j_sys.positions, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t_sys.box_extent, j_sys.box_extent)
    assert t_sys.n_waters == j_sys.n_waters
    assert t_sys.mol_start_indices == j_sys.mol_start_indices
    for s in STATIC_FIELDS:
        assert getattr(t_sys.topology, s) == getattr(j_sys.topology, s), s


def test_topology_from_numpy_roundtrip(systems):
    j_sys, _ = systems
    jt = j_sys.topology
    top = topology_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS},
        {s: getattr(jt, s) for s in STATIC_FIELDS}, device="cpu")
    for f in TENSOR_FIELDS:
        _assert_field(f, getattr(jt, f), getattr(top, f))
    assert top.n_atoms == jt.n_atoms


def test_make_topology_derives_exclusions_and_14():
    from molchanica_tpu.topology import make_topology as j_make
    args = dict(masses=[12.0, 1.0, 12.0, 12.0, 16.0],
                charges=[0.1, 0.2, -0.1, 0.3, -0.5],
                lj_sigma=[3.4, 2.5, 3.4, 3.4, 3.0],
                lj_eps=[0.1, 0.02, 0.1, 0.1, 0.2],
                bonds=[(0, 1, 300.0, 1.1), (0, 2, 300.0, 1.5),
                       (2, 3, 300.0, 1.5), (3, 4, 500.0, 1.2)],
                angles=[(1, 0, 2, 50.0, 1.9), (0, 2, 3, 60.0, 1.9),
                        (2, 3, 4, 70.0, 2.0)],
                dihedrals=[(1, 0, 2, 3, 0.2, 3.0, 0.0),
                           (0, 2, 3, 4, 1.0, 2.0, 3.14)],
                hclusters=[(0, [1], [1.1])], pad_atoms_to=8)
    jt = j_make(**args)
    tt = make_topology(**args)
    for f in TENSOR_FIELDS:
        _assert_field(f, getattr(jt, f), getattr(tt, f))


def test_minimum_image_and_wrap():
    rng = np.random.default_rng(0)
    box = np.array([20.0, 21.0, 22.5], np.float32)
    dx = rng.uniform(-40, 40, (500, 3)).astype(np.float32)
    # exact half-box ties: both libraries round half to even
    dx[:3] = box / 2
    dx[3:6] = -box / 2
    ref = np.asarray(j_mi(dx, box))
    got = minimum_image(torch.tensor(dx), torch.tensor(box)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        wrap(torch.tensor(dx), torch.tensor(box)).numpy(),
        np.asarray(j_wrap(dx, box)))


def test_intramol_pairs(systems):
    j_sys, t_sys = systems
    for a, b in zip(j_intramol(j_sys.topology),
                    intramol_pairs_np(t_sys.topology)):
        np.testing.assert_array_equal(a, b)
    # a coupled molecule: three atoms, one excluded pair
    import dataclasses
    top = dataclasses.replace(
        t_sys.topology,
        couple_mask=torch.zeros_like(t_sys.topology.couple_mask))
    top.couple_mask[:12] = 1.0
    jtop = j_sys.topology.replace(
        couple_mask=np.asarray(top.couple_mask.numpy()))
    for a, b in zip(j_intramol(jtop), intramol_pairs_np(top)):
        np.testing.assert_array_equal(a, b)


def test_config_defaults_match():
    from molchanica_tpu.md import config as jc
    from molchanica_tpu_torch.md import config as tc
    j, t = jc.MdConfig(), tc.MdConfig()
    for f in ("temp_target", "coulomb_cutoff", "lj_cutoff", "dtype",
              "neighbor_rebuild_every", "ewald_rtol", "seed",
              "zero_com_drift", "max_init_relaxation_iters", "use_pallas",
              "direct_backend", "steps_per_chunk", "cell_capacity_factor"):
        assert getattr(t, f) == getattr(j, f), f
    lj, lt = jc.Integrator.langevin_middle(1.0), \
        tc.Integrator.langevin_middle(1.0)
    assert (lt.kind, lt.gamma, lt.cadence, lt.thermostat_tau) == \
        (lj.kind, lj.gamma, lj.cadence, lj.thermostat_tau)
    assert tc.HydrogenConstraint.shake() == tc.HydrogenConstraint()
    assert jc.HydrogenConstraint.shake().kind == \
        tc.HydrogenConstraint.shake().kind


def test_fast_sim_needs_cuda_unless_cpu_is_asked(systems):
    """With no CUDA device the engine raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from molchanica_tpu_torch.md.config import MdConfig
    from molchanica_tpu_torch.md.fast_engine import FastSim
    _, t_sys = systems
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FastSim(t_sys.topology, MdConfig(max_init_relaxation_iters=None),
                    t_sys.positions, box_extent=t_sys.box_extent,
                    device=device)


def test_port_imports_no_jax():
    """Every module of the port (MdSim's backends, FIRE and integrators,
    the hydration path, the parallel package with the replica farm, the
    batch workloads of properties/, the barostat, snapshots, the probe,
    the PDB / SDF readers and GAFF2 chain, docking, density and the
    surface mesher among them), and chip_smoke, import without loading
    jax, flax or any molchanica_tpu module."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import molchanica_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'molchanica_tpu')]\n"
        "need = ['md.engine', 'md.energy', 'md.constraints', 'md.state', "
        "'ops.direct_force', 'ops.nonbonded', 'ops.pme', 'cuda_build', "
        "'md.alchemical', 'properties.water_sol', 'molecules.spec_json', "
        "'ops.pme2', 'parallel', 'parallel.comm', 'parallel.launch', "
        "'parallel.spatial', 'parallel.spatial_colpair', "
        "'parallel.dryrun', 'md.barostat', 'md.snapshot', "
        "'ops.probe_prefetch', 'ops.clusters', 'ops.cells', "
        "'md.minimize', 'md.integrators', 'md.dynamics', "
        "'systems.testmols', 'parallel.replicas', 'properties.logp', "
        "'properties.mixing', 'properties.shrinking_box', "
        "'properties.boundary_layer', 'properties.crystal', "
        "'systems.octanol', 'molecules.elements', 'molecules.common', "
        "'molecules.bond_inference', 'io.pdb', 'io.sdf', "
        "'molecules.pocket', 'ff.amber_dat', 'ff.data.gaff2_subset', "
        "'ff.typing_gaff', 'ff.charges', 'ff.params', 'docking.site', "
        "'docking.setup', 'docking.poses', 'docking.scorer', "
        "'docking.shoot', 'density', 'sfc_mesh']\n"
        "missing = [m for m in need if 'molchanica_tpu_torch.' + m "
        "not in sys.modules]\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('molchanica_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "assert not missing, missing\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 20
