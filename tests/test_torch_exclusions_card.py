"""On the card: the direct-space kernels leave the excluded and 1-4 pairs
out as their plain twins do, on config 3 (benchmark/data/eq25k.npz: the
24,940-site solvated polyalanine in a 59.79 A box, 9 A, the M sites
placed), at its stored start and moved whole so that the protein's centre
sits on the x face (hundreds of its excluded and 1-4 pairs straddle it),
for 1 and 13 replicas (0.05 A of jitter each).

K2 (csrc/direct_force.cu) against direct_force_plain with the topology's
exclusion table, per replica: per slot and per cell under 1e-5 of the
plain version's pair-term magnitudes (`direct_force_parity`), the kernel's
pair count equal to the plain count and below the count without the
table, two launches the same bits. The cluster kernel
(csrc/cluster_force.cu) against its plain twin (both looking the pairs
of the entries that the rebuild flags up in the same table): per site
|dF| under 1e-5 of the twin's f_abs, each energy term within 1e-6 of |E|
plus its |e| sum, two calls the same bits.

Skips without a card. This file imports no JAX, which the card's machine
lacks; tests/conftest.py does, so run it there without the conftest:
`python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_exclusions_card.py`.
"""
import os

import pytest
import torch

from molchanica_tpu_torch.md.energy import apply_virtual_sites
from molchanica_tpu_torch.ops import clusters as TCl
from molchanica_tpu_torch.ops import direct_force as TDF
from molchanica_tpu_torch.ops.exclusions import Exclusions, exclusion_table
from molchanica_tpu_torch.ops.pme import ewald_beta_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RC = 9.0


@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def config3(card):
    from benchmark import cells

    cfg = cells.load_config("config3_k2", ROOT)
    arrays, statics, box, x0 = cells.load_system(cfg, ROOT)
    top = cells.topology(arrays, statics, card)
    return top, torch.tensor(box, device=card), torch.tensor(x0, device=card)


def _states(config3, on_face, n_rep):
    """[R, N, 3] placed positions (wrapped into the box), the first at
    the start (or moved to the face), the others jittered."""
    top, box, x0 = config3
    x = x0.clone()
    if on_face:
        n = top.n_atoms_real
        solute = (top.dof_mask[:n] > 0).clone()
        solute[top.water_start:] = False
        shift = box / 2 - x[:n][solute].mean(0)
        shift[0] -= box[0] / 2
        x[:n] += shift
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    xs = [x] + [x + 0.05 * torch.randn(x.shape, generator=gen,
                                       device="cuda") * top.dof_mask[:, None]
                for _ in range(n_rep - 1)]
    x = torch.stack([apply_virtual_sites(xr, top) for xr in xs])
    return x - box * torch.floor(x / box)


@pytest.mark.card
@pytest.mark.parametrize("n_rep", [1, 13])
@pytest.mark.parametrize("on_face", [False, True])
def test_k2_leaves_the_excluded_pairs_out(config3, on_face, n_rep):
    top, box, _ = config3
    x = _states(config3, on_face, n_rep)
    plan = TDF.plan_window(box.cpu().numpy(), RC, top.n_atoms_real,
                           top.n_atoms, x0=x[0].cpu().numpy())
    direct = TDF.DirectForce(top, plan, exclusion_table(top))
    rebuild = TDF.make_rebuild_fn(plan, top.atom_mask)
    sa = torch.stack([rebuild(xr, box)[0] for xr in x])
    center, ghost = direct.inputs(x, box, sa)
    couple = torch.ones(n_rep, device="cuda")
    beta = torch.tensor(ewald_beta_for(RC, 1e-5), device="cuda")
    n_k = torch.zeros(n_rep, dtype=torch.int64, device="cuda")
    n_all = torch.zeros(n_rep, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        out = TDF.direct_force_cuda(plan, center, ghost, couple, beta,
                                    counts=n_k, excl=direct.excl)
        again = TDF.direct_force_cuda(plan, center, ghost, couple, beta,
                                      excl=direct.excl)
        TDF.direct_force_cuda(plan, center, ghost, couple, beta,
                              counts=n_all,
                              excl=Exclusions.empty(top.n_atoms, "cuda"))
        torch.cuda.synchronize()
    assert torch.equal(out, again)
    for r in range(n_rep):
        stats = {}
        ref = TDF.direct_force_plain(center[r], ghost[r], direct.starts,
                                     couple[r], beta, direct.rc2,
                                     stats=stats, excl=direct.excl)
        rel_f, rel_e = TDF.direct_force_parity(
            out[r, :, :3], TDF.cell_energies(out[r], plan.n_cells).sum(1),
            ref[:, :3], stats)
        print(f"K2 face {on_face} R={n_rep} replica {r}: per slot "
              f"{rel_f:.3e}, per cell {rel_e:.3e}, pairs {int(n_k[r])} "
              f"of {int(n_all[r])}")
        assert rel_f < 1e-5 and rel_e < 1e-5, (rel_f, rel_e)
        assert int(n_k[r]) == stats["pairs"] < int(n_all[r])


@pytest.mark.card
@pytest.mark.parametrize("n_rep", [1, 13])
@pytest.mark.parametrize("on_face", [False, True])
def test_cluster_kernel_leaves_the_excluded_pairs_out(config3, on_face,
                                                      n_rep):
    top, box, _ = config3
    x = _states(config3, on_face, n_rep)
    plan = TCl.plan_clusters(box.cpu().numpy(), RC, top.n_atoms_real,
                             top.n_atoms, m_scale=1.5)
    rebuild = TCl.make_cluster_rebuild_fn(plan, top, exclusion_table(top))
    lists = [rebuild(xr, box) for xr in x]
    assert all(int(ovf) == 0 for _, _, _, ovf in lists)
    order = torch.stack([o for o, _, _, _ in lists])
    nbr = torch.stack([nb for _, nb, _, _ in lists])
    flags = torch.stack([m for _, _, m, _ in lists])
    direct = TCl.make_cluster_direct_force_fn(top, None, plan,
                                              exclusion_table(top))
    beta = torch.tensor(ewald_beta_for(RC, 1e-5), device="cuda")
    c = torch.ones(n_rep, device="cuda")
    with torch.no_grad():
        f, e_lj, e_c, _ = direct(x, box, c, beta, order, nbr, flags)
        f2, e_lj2, e_c2, _ = direct(x, box, c, beta, order, nbr, flags)
        f0 = direct(x, box, c, beta, order, nbr, torch.zeros_like(flags))[0]
        torch.cuda.synchronize()
    assert torch.equal(f, f2) and torch.equal(e_lj, e_lj2) \
        and torch.equal(e_c, e_c2)
    # the flags do leave pairs out: without them the bonded atoms differ
    assert float((f - f0).abs().max()) > 1.0
    for r in range(n_rep):
        stats = {}
        f_p, lj_p, c_p, _ = direct.plain(x[r], box, c[r], beta, order[r],
                                         nbr[r], flags[r], stats=stats)
        d = (f[r] - f_p).abs().amax(1)
        ratio = float((d / (stats["f_abs"] + 1e-30)).max())
        rel_e = [abs(float(k) - float(p)) / (abs(float(p)) + a)
                 for k, p, a in zip((e_lj[r], e_c[r]), (lj_p, c_p),
                                    (stats["e_abs_lj"], stats["e_abs_c"]))]
        print(f"clusters face {on_face} R={n_rep} replica {r}: per site "
              f"{ratio:.3e}, energies {rel_e[0]:.3e} {rel_e[1]:.3e}")
        assert bool((d <= 1e-5 * stats["f_abs"]).all()), ratio
        assert max(rel_e) <= 1e-6, rel_e
