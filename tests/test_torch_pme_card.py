"""On the card: SPME's stencil kernels (csrc/pme_stencil.cu, through
ops/pme3.py's dispatch) against the dense plain version on the card, at
the two benchmark cells' shapes: config 3's (13 replicas of 25,088 sites,
60^3, a 59.7878 A box) and the duplex's (4 replicas of 10,496 sites, 48^3,
46 A), in float32 and float64. Positions and charges come from numpy:
uniform in the box, with sites at negative coordinates, beyond the box
and on mesh nodes (t = 0), and zero-charge sites (every fourth, as OPC's
oxygens, and the trailing padding). The plain route is the same
energy_parts / grads code with the module's two kernel wrappers swapped
for the dense spread and gather, replica by replica.

Compared: the batched energies, dE/dx and dE/dq (Pme3.batched under
autograd), and one replica through `_Pme3Fn` (energy, dE/dx, dE/dq and the
box gradient) and `value_and_grad`, each against the plain route in
float64 on the same (rounded) inputs. Tolerances, relative to the largest
magnitude of each quantity: float64 1e-12 (both sum the same terms in
another order: ~1e-15 each); float32 2e-5 for the energies and 1e-5 for
the gradients (the kernel forms each stencil term in float32 and sums the
mesh exactly in fixed point, the dense version sums 3,600 columns per mesh
row in float32; each float32 result is ~1e-6 of the largest magnitude
from float64, the dense one printed beside the kernel's). Also: two
spreads and two gathers give the same bits; the counters "pme_spread" and
"pme_gather" count one launch each per batched evaluation, whatever the
replicas; one batched evaluation at config 3's shape holds under 100 MB of
device memory beyond its inputs.

Skips without a card. This file imports no JAX, which the card's machine
lacks; tests/conftest.py does, so run it there without the conftest:
`python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_pme_card.py`.
"""
import numpy as np
import pytest
import torch

from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.ops import pme3
from molchanica_tpu_torch.ops.pme import ewald_beta_for

# (replicas, padded sites, real sites, mesh, box side)
SHAPES = {"config3": (13, 25_088, 24_940, (60, 60, 60), 59.7878),
          "duplex": (4, 10_496, 10_471, (48, 48, 48), 46.0)}
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-5, 1e-5)}
MEM_LIMIT = 100 * 2 ** 20


@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _inputs(shape, dtype, seed=5):
    """(pme, x [R, N, 3], q [R, N], box [3]) on the card, in dtype."""
    R, n, n_real, K, side = SHAPES[shape]
    rng = np.random.default_rng(seed)
    box = np.full(3, side)
    x = rng.uniform(0.0, 1.0, (R, n, 3)) * box
    x[:, 0:64] -= box * rng.uniform(0.01, 1.0, (R, 64, 1))     # negative
    x[:, 64:128] += box * rng.integers(1, 3, (R, 64, 1))       # beyond
    nodes = rng.integers(-K[0], 2 * K[0], (R, 64, 3))
    x[:, 128:192] = nodes * (box / np.array(K))                 # on nodes
    x[:, 192] = 0.0
    x[:, 193] = box
    x[:, 194] = -box
    x[:, 195] = box / 2
    q = rng.normal(0.0, 0.5, (R, n))
    q[:, ::4] = 0.0
    q[:, n_real:] = 0.0
    pme = pme3.Pme3(K, ewald_beta_for(9.0, 1e-5), device="cuda",
                    dtype=dtype)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
    return pme, as_t(x), as_t(q), as_t(box)


def _reference(shape, fn, x, q, box):
    """fn(pme, x, q, box) through the plain route in float64 on the same
    (rounded) inputs, and through the plain route in their dtype."""
    p64 = pme3.Pme3(SHAPES[shape][3], ewald_beta_for(9.0, 1e-5),
                    device="cuda", dtype=torch.float64)
    p = pme3.Pme3(SHAPES[shape][3], ewald_beta_for(9.0, 1e-5),
                  device="cuda", dtype=x.dtype)
    with pytest.MonkeyPatch.context() as m:
        _plain(m, p64)
        ref = fn(p64, x.double(), q.double(), box.double())
        _plain(m, p)
        same = fn(p, x, q, box)
    return ref, same


def _plain(monkeypatch, pme):
    """Route pme3's spread and gather through the dense plain version,
    replica by replica."""
    def spread(K, x, q, box):
        if x.dim() == 2:
            return pme._spread_plain(x, q, box)
        return torch.stack([pme._spread_plain(x[r], q[r], box)
                            for r in range(x.shape[0])])

    def gather(K, x, q, box, phi):
        if x.dim() == 2:
            return pme._gather_plain(x, q, box, phi)
        out = [pme._gather_plain(x[r], q[r], box, phi[r])
               for r in range(x.shape[0])]
        return (torch.stack([g for g, _ in out]),
                torch.stack([g for _, g in out]))

    monkeypatch.setattr(pme3, "pme_spread_cuda", spread)
    monkeypatch.setattr(pme3, "pme_gather_cuda", gather)


def _batched(pme, x, q, box):
    """(energies [R], dE/dx, dE/dq) through Pme3.batched and autograd."""
    xg = x.clone().requires_grad_(True)
    qg = q.clone().requires_grad_(True)
    with torch.enable_grad():
        e = pme.batched(xg, qg, box)
        gx, gq = torch.autograd.grad(e.sum(), (xg, qg))
    return e.detach(), gx, gq


def _single(pme, x, q, box):
    """(E, dE/dx, dE/dq, dE/dbox) through _Pme3Fn, and value_and_grad's
    (E, dE/dx), for one replica."""
    xg = x.clone().requires_grad_(True)
    qg = q.clone().requires_grad_(True)
    bg = box.clone().requires_grad_(True)
    with torch.enable_grad():
        e = pme(xg, qg, bg)
        grads = torch.autograd.grad(e, (xg, qg, bg))
    return (e.detach(),) + grads + pme.value_and_grad(x, q, box)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batched_matches_plain(card, shape, dtype):
    pme, x, q, box = _inputs(shape, dtype)
    tracing.reset_counters("pme_")
    kern = _batched(pme, x, q, box)
    torch.cuda.synchronize()
    assert tracing.counters("pme_") == {"pme_spread": 1, "pme_gather": 1}
    ref, same = _reference(shape, _batched, x, q, box)
    assert tracing.counters("pme_") == {"pme_spread": 1, "pme_gather": 1}
    tol_e, tol_g = TOL[dtype]
    rel = [_rel(k.double(), r) for k, r in zip(kern, ref)]
    rel_p = [_rel(p.double(), r) for p, r in zip(same, ref)]
    print(f"{shape} {dtype} batched vs float64 plain: energies {rel[0]:.3e}"
          f", dE/dx {rel[1]:.3e}, dE/dq {rel[2]:.3e} (the plain version in "
          f"{dtype}: {rel_p[0]:.3e}, {rel_p[1]:.3e}, {rel_p[2]:.3e})")
    assert rel[0] <= tol_e and max(rel[1:]) <= tol_g, rel
    assert not kern[1][:, SHAPES[shape][2]:].any()   # padding: no charge


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_single_paths_match_plain(card, shape, dtype):
    """_Pme3Fn (MdSim, with the barostat's box gradient) and value_and_grad
    (FastSim) take the same kernels with one replica."""
    pme, x, q, box = _inputs(shape, dtype, seed=6)
    x, q = x[0], q[0]
    tracing.reset_counters("pme_")
    kern = _single(pme, x, q, box)
    torch.cuda.synchronize()
    # the energy, its gradient with the box's (whose spread is a third)
    # and value_and_grad
    assert tracing.counters("pme_") == {"pme_spread": 3, "pme_gather": 2}
    ref, same = _reference(shape, _single, x, q, box)
    tol_e, tol_g = TOL[dtype]
    rel = [_rel(k.double(), r) for k, r in zip(kern, ref)]
    rel_p = [_rel(p.double(), r) for p, r in zip(same, ref)]
    print(f"{shape} {dtype} single vs float64 plain: E {rel[0]:.3e}, dE/dx "
          f"{rel[1]:.3e}, dE/dq {rel[2]:.3e}, dE/dbox {rel[3]:.3e}; "
          f"value_and_grad E {rel[4]:.3e}, dE/dx {rel[5]:.3e} (the plain "
          f"version in {dtype}: {', '.join(f'{v:.3e}' for v in rel_p)})")
    assert max(rel[0], rel[3], rel[4]) <= tol_e, rel
    assert max(rel[1], rel[2], rel[5]) <= tol_g, rel


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_spread_and_gather_are_deterministic(card, shape):
    """A checkpoint's continuations repeat bit for bit only if both do."""
    pme, x, q, box = _inputs(shape, torch.float32, seed=7)
    K = pme.K
    phi = torch.randn((x.shape[0],) + K, device="cuda")
    tracing.reset_counters("pme_")
    with torch.no_grad():
        mesh1 = pme3.pme_spread_cuda(K, x, q, box)
        mesh2 = pme3.pme_spread_cuda(K, x, q, box)
        gx1, gq1 = pme3.pme_gather_cuda(K, x, q, box, phi)
        gx2, gq2 = pme3.pme_gather_cuda(K, x, q, box, phi)
    torch.cuda.synchronize()
    assert torch.equal(mesh1, mesh2)
    assert torch.equal(gx1, gx2) and torch.equal(gq1, gq2)
    assert tracing.counters("pme_") == {"pme_spread": 2, "pme_gather": 2}


@pytest.mark.card
def test_batched_memory_at_config3(card):
    """The dense version held three [R, N, Ky Kz] panels (13.1 GiB at
    config 3); the kernels hold the meshes and the DFT's temporaries."""
    pme, x, q, box = _inputs("config3", torch.float32)
    _batched(pme, x, q, box)                      # build and warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _batched(pme, x, q, box)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    print(f"config3 batched evaluation: {extra / 2 ** 20:.1f} MiB above "
          f"its inputs")
    assert extra < MEM_LIMIT
