"""Port parity of the spatial decomposition (molchanica_tpu_torch.parallel)
against molchanica_tpu.parallel on the CPU. The port's ranks are spawned
processes over gloo, running the plain kernel twin; the JAX side runs on
an n-device sub-mesh of the 8 virtual CPU devices, with the Pallas kernel
in interpret mode.

Tolerances: partition_slabs, pad_plan_for_mesh and halo_depth_for exactly
equal; pme2 in float64, energy rel 1e-10 and gradient 1e-9 of its largest
component (the same spline sums and FFTs in both libraries); the dense
slab force against JAX and against the port's single-device reference,
energies rel 1e-5 and forces 1e-5 of max|F| (float32 summation order),
with PME 2e-5 of max|F| (the JAX test's bound: the recip mesh sums in
float32); the sharded colpair against JAX's and against the port's
single-device kernel, forces 5e-6 of max|F| and energies rel 1e-5 (the
JAX test's bounds); spatial_md_run at gamma 0 (the noise is multiplied by
zero), positions within 1e-3 A and kinetic energies rel 1e-4 after two
10-step chunks. Called without a device, every parallel entry point takes
the card and, without one, raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from molchanica_tpu.ops.pme2 import make_pme2_recip_fn as j_pme2
from molchanica_tpu.parallel import spatial as JS
from molchanica_tpu.parallel import spatial_colpair as JC
from molchanica_tpu_torch.ops.colpair import ColpairDirect
from molchanica_tpu_torch.ops.pme2 import make_pme2_recip_fn
from molchanica_tpu_torch.parallel import spatial as TS
from molchanica_tpu_torch.parallel import spatial_colpair as TC
from molchanica_tpu_torch.parallel.comm import Comm
from molchanica_tpu_torch.parallel.dryrun import (dryrun_multidevice,
                                                  sorted_colpair_state)
from molchanica_tpu_torch.parallel.launch import run_ranks
from test_torch_colpair import _jplan

torch.set_num_threads(1)
N_DEV = 4


def _mesh(n=N_DEV):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def _slab_system():
    rng = np.random.default_rng(5)
    n = 800
    box = np.array([48.0, 16.0, 16.0])
    x = rng.uniform(0, 1, (n, 3)) * box
    return (x, rng.normal(0, 0.3, n), rng.uniform(1.2, 1.7, n),
            rng.uniform(0.1, 0.6, n), box)


def _ionic_lattice():
    rng = np.random.default_rng(11)
    box = np.array([48.0, 16.0, 16.0])
    gx, gy, gz = np.meshgrid(np.linspace(1.5, box[0] - 2, 13),
                             np.linspace(1.5, box[1] - 2, 4),
                             np.linspace(1.5, box[2] - 2, 4), indexing="ij")
    x = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    x = x + rng.uniform(-0.4, 0.4, x.shape)
    n = len(x)
    q = np.where(np.arange(n) % 2 == 0, 0.5, -0.5)
    return x, q, np.full(n, 1.6), np.full(n, 0.6), box


def _grouped(owner, a):
    out = np.zeros(owner.shape, np.float32)
    for d in range(owner.shape[0]):
        ids = owner[d][owner[d] >= 0]
        out[d, :len(ids)] = a[ids]
    return out


def test_partition_slabs_equal():
    x, _, _, _, box = _slab_system()
    for n_dev in (4, 8):
        for a, b in zip(TS.partition_slabs(x, box, n_dev),
                        JS.partition_slabs(x, box, n_dev)):
            np.testing.assert_array_equal(a, b)


def test_pme2_matches_jax():
    rng = np.random.default_rng(0)
    n = 300
    box = np.array([18.0, 19.0, 20.0])
    x = rng.uniform(0, 1, (n, 3)) * box
    q = rng.normal(0, 0.5, n)
    grid, beta = (18, 20, 20), 0.39
    recip = make_pme2_recip_fn(grid, beta, dtype=torch.float64, chunk=128,
                               device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    e = recip(xt, torch.tensor(q), torch.tensor(box))
    (g,) = torch.autograd.grad(e, xt)
    jr = j_pme2(grid, beta, dtype=jnp.float64, chunk=128)
    ej, gj = jax.value_and_grad(jr)(jnp.asarray(x), jnp.asarray(q),
                                    jnp.asarray(box))
    assert abs(float(e.detach()) - float(ej)) <= 1e-10 * abs(float(ej))
    gj = np.asarray(gj)
    assert np.abs(g.numpy() - gj).max() <= 1e-9 * np.abs(gj).max()


def _dense_case(system, beta, pme_grid):
    x, q, sig, eps, box = system
    xs, mask, owner = TS.partition_slabs(x, box, N_DEV)
    qs, ss, es = (_grouped(owner, a) for a in (q, sig, eps))
    e_t, f_t = TS.run_spatial_force(N_DEV, "gloo", "cpu", xs, mask, qs, ss,
                                    es, box, 5.5, beta=beta,
                                    pme_grid=pme_grid)
    fn = jax.jit(JS.make_spatial_force_fn(_mesh(), "x", box, 5.5, beta=beta,
                                          pme_grid=pme_grid))
    e_j, f_j = fn(*(jnp.asarray(a) for a in (xs, mask, qs, ss, es)))
    keep = owner >= 0
    return (e_t, np.asarray(e_j), f_t.numpy()[keep], np.asarray(f_j)[keep],
            (xs, mask, qs, ss, es, keep))


def test_spatial_force_matches_jax_and_one_device():
    e_t, e_j, f_t, f_j, (xs, mask, qs, ss, es, keep) = _dense_case(
        _slab_system(), None, None)
    assert np.allclose(e_t, e_t[0], rtol=0, atol=0)
    assert abs(e_t[0] - float(e_j[0])) <= 1e-5 * abs(float(e_j[0]))
    scale = np.abs(f_j).max()
    assert np.abs(f_t - f_j).max() <= 1e-5 * scale
    flat = lambda a: torch.tensor(a.reshape((-1,) + a.shape[2:]))
    e_r, f_r = TS.spatial_reference_force(
        flat(xs), flat(mask), flat(qs), flat(ss), flat(es),
        _slab_system()[4], 5.5)
    assert abs(e_t[0] - float(e_r)) <= 1e-5 * abs(float(e_r))
    assert np.abs(f_t - f_r.numpy()[keep.reshape(-1)]).max() <= 1e-5 * scale


def test_spatial_pme_force_matches_jax_and_one_device():
    """The port takes the local rows of dE/dx of the replicated recip
    energy; the JAX package divides its all_gather cotangent by n_dev.
    Both must give the single-device Ewald force."""
    system = _ionic_lattice()
    beta, grid = 0.45, (16, 16, 16)
    e_t, e_j, f_t, f_j, (xs, mask, qs, ss, es, keep) = _dense_case(
        system, beta, grid)
    assert np.allclose(e_t, e_t[0], rtol=1e-6, atol=0)
    assert abs(e_t[0] - float(e_j[0])) <= 1e-5 * abs(float(e_j[0]))
    scale = np.abs(f_j).max()
    assert np.abs(f_t - f_j).max() <= 2e-5 * scale
    # one device: erfc direct over all pairs + the same recip + self
    from molchanica_tpu_torch.constants import COULOMB_CONST
    flat = lambda a: torch.tensor(a.reshape((-1,) + a.shape[2:]))
    x, m, q = flat(xs), flat(mask), flat(qs)
    qk = q * float(np.sqrt(COULOMB_CONST))
    boxt = torch.tensor(system[4], dtype=torch.float32)
    e_dir, f_dir = TS._pair_energy_force(x, m, x, m, qk, qk, flat(ss),
                                         flat(ss), flat(es), flat(es), boxt,
                                         5.5, beta=beta)
    q_real = q * (m > 0)
    xr = x.clone().requires_grad_(True)
    e_rec = make_pme2_recip_fn(grid, beta, device="cpu")(xr, q_real, boxt)
    (g,) = torch.autograd.grad(e_rec, xr)
    e_self = -beta / np.sqrt(np.pi) * COULOMB_CONST * float(
        torch.sum(q_real * q_real))
    e_ref = float(e_dir) + float(e_rec.detach()) + e_self
    assert abs(e_t[0] - e_ref) <= 1e-5 * abs(e_ref)
    f_ref = (f_dir - g).numpy()[keep.reshape(-1)]
    assert np.abs(f_t - f_ref).max() <= 2e-5 * np.abs(f_ref).max()


def test_spatial_md_run_matches_jax():
    rng = np.random.default_rng(3)
    box = np.array([8.0 * N_DEV, 14.0, 14.0])
    gx, gy, gz = np.meshgrid(np.linspace(2, box[0] - 2, 8),
                             np.linspace(2, box[1] - 2, 4),
                             np.linspace(2, box[2] - 2, 3), indexing="ij")
    x0 = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    n = len(x0)
    x0 = (x0 + rng.uniform(-0.15, 0.15, x0.shape)).astype(np.float32)
    masses = np.full(n, 39.9, np.float32)
    q = np.zeros(n, np.float32)
    sig = np.full(n, 1.7, np.float32)
    eps = np.full(n, 2 * np.sqrt(0.24), np.float32)
    v0 = rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    kw = dict(rc=6.0, dt=0.002, n_steps=20, rebuild_every=10, gamma=0.0,
              temp_target=120.0, seed=1)
    x_t, v_t, ke_t = TS.run_spatial_md(N_DEV, "gloo", "cpu", x0, v0, masses,
                                       q, sig, eps, box, **kw)
    x_j, v_j, ke_j = JS.spatial_md_run(x0.copy(), v0.copy(), masses, q, sig,
                                       eps, box, _mesh(), "x", **kw)
    assert len(ke_t) == len(ke_j) == 2
    np.testing.assert_allclose(ke_t, ke_j, rtol=1e-4)
    assert np.abs(x_t - np.asarray(x_j)).max() < 1e-3
    assert np.abs(x_t - x0).max() > 1e-3              # the atoms moved


def _colpair_case(box, n, want_energy, halo=None):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (n, 3)) * box
    plan, rows, wl, nw, boxt = sorted_colpair_state(
        x, rng.normal(0, 0.4, n), rng.uniform(2.6, 3.4, n),
        rng.uniform(0.05, 0.25, n), box, 6.0, N_DEV, device="cpu")
    h = TC.halo_depth_for(plan, N_DEV, wl, nw)
    jplan = _jplan(plan)
    assert h == JC.halo_depth_for(jplan, N_DEV, np.asarray(wl),
                                  np.asarray(nw))
    halo = h if halo is None else halo
    f_t, elj_t, ec_t = TC.run_sharded_colpair(
        N_DEV, "gloo", "cpu", plan, halo, rows, wl, nw, boxt,
        want_energy=want_energy)
    sharded = JC.make_sharded_colpair_direct(
        _mesh(), "x", jplan, halo, want_energy=want_energy, interpret=True)
    one = jnp.asarray(1.0, jnp.float32)
    jr = lambda t: jnp.asarray(t.numpy())
    with _mesh():
        f_j, elj_j, ec_j = jax.jit(sharded)(jr(rows), jr(wl), jr(nw),
                                            jr(boxt), one)
    f_1, elj_1, ec_1 = ColpairDirect(plan, want_energy, range_tables=True)(
        rows, rows.T.contiguous(), wl, nw, boxt, 1.0)
    f_j = np.asarray(f_j)
    scale = float(f_1.abs().max())
    assert scale > 0
    for f_ref, e_ref in ((f_j, (elj_j, ec_j)), (f_1.numpy(), (elj_1, ec_1))):
        assert np.abs(f_t.numpy() - f_ref).max() <= 5e-6 * scale
        for got, ref in zip((elj_t, ec_t), e_ref):
            ref = float(ref)
            assert abs(got - ref) <= 1e-5 * max(abs(ref), 1.0)
    if want_energy:
        assert abs(ec_t) > 0 and abs(elj_t) > 0
    return h, halo


def test_sharded_colpair_halo_one():
    """996 atoms over 4 ranks: a halo of one block on each side."""
    h, halo = _colpair_case(np.array([40.0, 21.0, 21.0]), 996, True)
    assert h == halo == 1


def test_sharded_colpair_antipode():
    """600 atoms over 4 ranks, force-only: the halo reaches the ring's
    antipode (2 halo + 1 == n_dev + 1), so the local j array holds the
    opposite block twice."""
    h, halo = _colpair_case(np.array([21.0, 22.0, 23.0]), 600, False,
                            halo=2)
    assert 2 * halo + 1 == N_DEV + 1 and h <= halo


def test_plan_padding_equal():
    from molchanica_tpu_torch.ops.colpair import plan_columns
    plan = plan_columns(np.array([21.0, 22.0, 23.0]), 6.0, 0.5, 600, 640,
                        skin=0.5)
    for n_dev in (1, 3, 4, 8):
        assert TC.pad_plan_for_mesh(plan, n_dev).n_sorted == \
            JC.pad_plan_for_mesh(_jplan(plan), n_dev).n_sorted


def test_dryrun_multidevice_cpu():
    out = dryrun_multidevice(N_DEV, "gloo", "cpu")
    assert out["backend"] == "gloo" and out["colpair_err"] < 5e-6
    assert len(out["kes"]) == 2 and out["halo"] >= 1


def test_a_failing_rank_fails_the_run():
    """fn(rank, n, device) with a signature that does not take those three
    arguments raises in every rank; the parent raises too."""
    with pytest.raises(Exception):
        run_ranks(TC.pad_plan_for_mesh, 2, "gloo", "cpu")


_BOX = np.array([20.0, 20.0, 20.0])
_X = np.zeros((4, 3))
_DEFAULT_DEVICE_CALLS = {
    "make_spatial_force_fn": lambda: TS.make_spatial_force_fn(None, _BOX, 6.0),
    "make_spatial_step_fn": lambda: TS.make_spatial_step_fn(
        None, _BOX, 6.0, 0.002, 1.0, 300.0),
    "spatial_md_run": lambda: TS.spatial_md_run(
        _X, _X, np.ones(4), np.zeros(4), np.ones(4), np.ones(4), _BOX, None,
        6.0, 0.002, 1),
    "ShardedColpair": lambda: TC.ShardedColpair(None, None, 1),
    "make_sharded_colpair_direct": lambda: TC.make_sharded_colpair_direct(
        None, None, 1),
    "sorted_colpair_state": lambda: sorted_colpair_state(
        _X, np.zeros(4), np.ones(4), np.ones(4), _BOX, 6.0, 4),
    "Comm": lambda: Comm(None),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    """Called without a device, each parallel entry point takes the CUDA
    card, and without one raises before it touches a process group (the
    card is hidden, so the check runs on any host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CALLS[name]()


@pytest.mark.slow
def test_sharded_colpair_25k():
    """The JAX package's 25k case on the port: config 3's 25,088 sites at
    the eq25k.npz state, every site its own exclusion group, 8 ranks over
    gloo against the port's single-device kernel; forces within 1e-4 of
    max|F| and Coulomb energy rel 1e-5 (the JAX test's bounds)."""
    import os

    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein
    n_dev = 8
    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    top = asys.topology
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    x = np.load(os.path.join(root, "molchanica_tpu", "systems", "data",
                             "eq25k.npz"))["x"].astype(np.float64)
    plan, rows, wl, nw, boxt = sorted_colpair_state(
        x, (top.charges * top.atom_mask).numpy().astype(np.float64),
        top.lj_sigma.numpy().astype(np.float64),
        top.lj_eps.numpy().astype(np.float64),
        np.asarray(asys.box_extent, np.float64), 9.0, n_dev,
        device="cpu")
    halo = TC.halo_depth_for(plan, n_dev, wl, nw)
    f_t, _, ec_t = TC.run_sharded_colpair(n_dev, "gloo", "cpu", plan, halo,
                                          rows, wl, nw, boxt)
    f_1, _, ec_1 = ColpairDirect(plan, True, range_tables=True)(
        rows, rows.T.contiguous(), wl, nw, boxt, 1.0)
    assert float((f_t - f_1).abs().max()) < 1e-4 * float(f_1.abs().max())
    assert abs(ec_t - float(ec_1)) < 1e-5 * abs(float(ec_1))
