"""On the card: the cluster force kernel (csrc/cluster_force.cu, through
ops/clusters.py's dispatch) against its plain twin on the card, on config
5's duplex at its stored start (benchmark/data/config5_duplex_start.npz:
10,471 real sites in a 46 A box, the M sites placed, 9 A, the list at x 1.5
width), for 1 and 4 replicas (0.05 A of jitter each), float32 and float64,
couple 1 and 0.5 with the first 30 solute atoms coupled.

Gates: per site |dF| under 1e-5 (float32) / 1e-12 (float64) of the site's
pair-term magnitudes (the plain twin's stats["f_abs"]); each energy term
within 1e-6 / 1e-12 of its magnitude |E| + the half sum of |e| (the
twin's float32 sums run over 2 M pair slots per block, the kernel's in
double); two calls give the same bits; one "cluster_force" launch per
call whatever the replicas; an input that requires grad raises.

Skips without a card. This file imports no JAX, which the card's machine
lacks; tests/conftest.py does, so run it there without the conftest:
`python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cluster_force_card.py`.
"""
import os

import pytest
import torch

from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.md.energy import apply_virtual_sites
from molchanica_tpu_torch.ops import clusters as TCl
from molchanica_tpu_torch.ops.exclusions import exclusion_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RC = 9.0
BETA = 0.35
N_COUPLED = 30
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 1e-12)}


@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def duplex(card):
    """(topology in float32 with the first solute atoms coupled, box, the
    stored start) on the card."""
    from benchmark import cells

    cfg = cells.load_config("config5_duplex", ROOT)
    arrays, statics, box, x0 = cells.load_system(cfg, ROOT)
    top = cells.topology(arrays, statics, card)
    cm = torch.zeros_like(top.couple_mask)
    solute = torch.nonzero(top.dof_mask > 0)[:, 0]
    cm[solute[:N_COUPLED]] = 1.0
    top.couple_mask = cm
    return (top, torch.tensor(box, device=card),
            torch.tensor(x0, device=card))


def _case(duplex, dtype, n_rep):
    top, box, x0 = duplex
    top = top.to("cuda", dtype)
    box = box.to(dtype)
    plan = TCl.plan_clusters(box.cpu().numpy(), RC, top.n_atoms_real,
                             top.n_atoms, m_scale=1.5)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    xs = []
    for r in range(n_rep):
        x = x0.to(dtype)
        if r:
            x = x + 0.05 * torch.randn(x.shape, generator=gen, dtype=dtype,
                                       device="cuda") * top.dof_mask[:, None]
        xs.append(apply_virtual_sites(x, top))
    x = torch.stack(xs)
    rebuild = TCl.make_cluster_rebuild_fn(plan, top, exclusion_table(top))
    lists = [rebuild(xr, box) for xr in x]
    assert all(int(ovf) == 0 for _, _, _, ovf in lists)
    order = torch.stack([o for o, _, _, _ in lists])
    nbr = torch.stack([nb for _, nb, _, _ in lists])
    flags = torch.stack([m for _, _, m, _ in lists])
    direct = TCl.make_cluster_direct_force_fn(top, None, plan,
                                              exclusion_table(top))
    return top, plan, direct, x, box, order, nbr, flags


@pytest.mark.card
@pytest.mark.parametrize("couple", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_kernel_matches_plain_twin(duplex, n_rep, dtype, couple):
    top, plan, direct, x, box, order, nbr, flags = _case(duplex, dtype,
                                                         n_rep)
    beta = torch.tensor(BETA, dtype=dtype, device="cuda")
    c = torch.full((n_rep,), couple, dtype=dtype, device="cuda")
    if n_rep == 1:
        x, order, nbr, flags, c = x[0], order[0], nbr[0], flags[0], c[0]
    tol_f, tol_e = TOL[dtype]
    with torch.no_grad():
        k0 = tracing.counters("cluster_force").get("cluster_force", 0)
        f, e_lj, e_c, _ = direct(x, box, c, beta, order, nbr, flags)
        f2, e_lj2, e_c2, _ = direct(x, box, c, beta, order, nbr, flags)
        f3, e_lj3, e_c3, _ = direct(x, box, c, beta, order, nbr, flags,
                                    want_force=False)
        torch.cuda.synchronize()
        k1 = tracing.counters("cluster_force").get("cluster_force", 0)
        assert k1 - k0 == 3
        assert torch.equal(f, f2) and torch.equal(e_lj, e_lj2) \
            and torch.equal(e_c, e_c2)
        assert f3 is None and torch.equal(e_lj3, e_lj) \
            and torch.equal(e_c3, e_c)
        if n_rep > 1:
            # replicas a padded stride apart, as the farm's placed sites lie
            xp = torch.zeros((n_rep, plan.n_atoms + 1, 3), dtype=dtype,
                             device="cuda")[:, :plan.n_atoms]
            xp.copy_(x)
            fp, e_ljp, _, _ = direct(xp, box, c, beta, order, nbr, flags)
            assert torch.equal(fp, f) and torch.equal(e_ljp, e_lj)
        if n_rep == 1:
            x, order, nbr, flags, c, f = x[None], order[None], nbr[None], \
                flags[None], c[None], f[None]
        for r in range(n_rep):
            stats = {}
            f_p, lj_p, c_p, _ = direct.plain(x[r], box, c[r], beta, order[r],
                                             nbr[r], flags[r], stats=stats)
            f_r = f[r]
            d = (f_r - f_p).abs().amax(1)
            ratio = float((d / (stats["f_abs"] + 1e-30)).max())
            e_k = (e_lj.reshape(-1)[r], e_c.reshape(-1)[r])
            rel_e = [abs(float(k) - float(p)) / (abs(float(p)) + a)
                     for k, p, a in zip(e_k, (lj_p, c_p),
                                        (stats["e_abs_lj"],
                                         stats["e_abs_c"]))]
            print(f"R={n_rep} {dtype} couple {couple} replica {r}: per site "
                  f"|dF| / f_abs {ratio:.3e}, energies {rel_e[0]:.3e} "
                  f"{rel_e[1]:.3e} (e_lj {float(e_k[0]):.4f} vs "
                  f"{float(lj_p):.4f}, e_c {float(e_k[1]):.4f} vs "
                  f"{float(c_p):.4f})")
            assert bool((d <= tol_f * stats["f_abs"]).all()), ratio
            assert max(rel_e) <= tol_e, rel_e
            assert not f_r[top.atom_mask == 0].any()


@pytest.mark.card
def test_kernel_refuses_grad_and_stats(duplex):
    _, _, direct, x, box, order, nbr, flags = _case(duplex, torch.float32,
                                                    1)
    beta = torch.tensor(BETA, device="cuda")
    c = torch.tensor(1.0, device="cuda")
    xg = x[0].clone().requires_grad_(True)
    with torch.enable_grad(), pytest.raises(ValueError, match="gradient"):
        direct(xg, box, c, beta, order[0], nbr[0], flags[0])
    cg = c.clone().requires_grad_(True)
    with torch.enable_grad(), pytest.raises(ValueError, match="gradient"):
        direct(x[0], box, cg, beta, order[0], nbr[0], flags[0],
               want_force=False)
    with pytest.raises(ValueError, match="plain"):
        direct(x[0], box, c, beta, order[0], nbr[0], flags[0], stats={})
    # the plain twin on the card keeps its gradient
    with torch.enable_grad():
        _, e_lj, e_c, _ = direct.plain(xg, box, c, beta, order[0], nbr[0],
                                       flags[0], want_force=False)
        (g,) = torch.autograd.grad(e_lj + e_c, xg)
    assert torch.isfinite(g).all()
