"""Where the JAX package's MdSim, the parity tests' reference, differs from
the port by design, and what those tests allow for it.

Its direct-space backends add every close pair, the excluded and 1-4
pairs too, and its rest energy subtracts those again with the same
formula; the port leaves them out (ops/exclusions.py). Two things follow.

- float32: a bonded pair at 1-1.5 A carries ~1e4-1e6 kcal/mol/A of LJ
  force, so the reference's forces and energies carry a residue of that
  size times ~1e-7 where such pairs sit. The port's own scales
  (MdSim.direct_space_scales) no longer hold them; `reference_scales`
  adds the excluded and 1-4 pairs' term magnitudes, counted as the plain
  kernel counts a pair's (ops/direct_force.py, `direct_force_plain`'s
  stats).
- float64: the reference's kernels give an excluded pair an analytic force
  that takes the exact erfc's slope, and its rest energy subtracts it by
  autograd of the A&S polynomial, whose slope differs: the two miss each
  other by ~2.8e-4 kcal/mol/A at every water H. Inside `kernel_slope()`
  the reference's subtraction takes the kernel's slope (the same values),
  so that it adds and subtracts what the port leaves out.
"""
import contextlib

import jax
import jax.numpy as jnp
import jax.scipy.special
import pytest
import torch

import molchanica_tpu.ops.pallas.direct_force as JDF
from molchanica_tpu_torch.md.energy import apply_virtual_sites
from molchanica_tpu_torch.ops.direct_force import _pair_terms
from molchanica_tpu_torch.ops.exclusions import exclusion_pairs
from molchanica_tpu_torch.ops.pbc import minimum_image


def excluded_pair_scales(ts, x):
    """Per atom [N], the sum over its excluded and 1-4 pairs inside the
    cutoff of 2 r (|LJ term| + |Coulomb term|) of dV/dr2 (M-site rows
    spread onto O/H1/H2 as the force is), and {"lj", "coulomb"}: the sums
    of |e_lj| and |e_c| over those pairs; in float64."""
    top = ts.top
    xv = apply_virtual_sites(x, top).double()
    box = ts.state.box.double()
    rc = max(ts.cfg.lj_cutoff, ts.cfg.coulomb_cutoff)
    p = torch.as_tensor(exclusion_pairs(top), device=xv.device)
    i, j = p[:, 0], p[:, 1]
    d = minimum_image(xv[i] - xv[j], box)
    r2 = torch.sum(d * d, dim=-1)
    ok = r2 < rc * rc
    i, j, d, r2 = i[ok], j[ok], d[ok], r2[ok]
    q = (top.charges * top.atom_mask).double()
    one = torch.ones_like(r2)

    def cols(k, pos):
        return (pos[:, 0], pos[:, 1], pos[:, 2], q[k],
                top.lj_sigma.double()[k], top.lj_eps.double()[k],
                top.couple_mask.double()[k], one)

    _, e_lj, e_c, _, mag = _pair_terms(
        cols(i, d), cols(j, torch.zeros_like(d)),
        ts.state.couple.double(), float(ts._beta), True)
    term = 2.0 * mag * torch.sqrt(r2)
    a = torch.zeros(top.atom_mask.shape[0], dtype=torch.float64,
                    device=xv.device)
    a = a.index_add(0, i, term).index_add(0, j, term)[:, None]
    vs = top.vsite_idx
    am = a[vs[:, 0]] * top.vsite_mask.double()[:, None]
    for col in (1, 2, 3):
        a = a.index_add(0, vs[:, col], am)
    return a[:, 0], {"lj": float(torch.abs(e_lj).sum()),
                     "coulomb": float(torch.abs(e_c).sum())}


def reference_scales(ts, x):
    """MdSim.direct_space_scales(x) of the port plus the excluded and 1-4
    pairs' magnitudes (`excluded_pair_scales`): the float32 scales of the
    reference's direct space at x."""
    f, e = ts.direct_space_scales(x)
    fx, ex = excluded_pair_scales(ts, x)
    return f + fx.to(f.dtype), {k: e[k] + ex[k] for k in e}


_AS_ERFC = JDF.erfc_approx


def _erfc_exact_slope(x):
    """The A&S erfc's value with the exact erfc's derivative."""
    v, _ = _AS_ERFC(jax.lax.stop_gradient(x))
    exact = jax.scipy.special.erfc(x)
    return v + exact - jax.lax.stop_gradient(exact), jnp.exp(-x * x)


@contextlib.contextmanager
def kernel_slope():
    """The reference's exclusion subtraction (pairlist_kernel_formula_energy
    in molchanica_tpu.ops.pallas.direct_force) differentiated with its
    kernels' erfc slope, for the length of the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDF, "erfc_approx", _erfc_exact_slope)
        yield
