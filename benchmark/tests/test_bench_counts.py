"""benchmark/counts.py and the reference's pair count against hand counts
on a tiny box."""
import math

import numpy as np
import pytest
import torch

from benchmark import counts
from benchmark.reference.physics import System


def bare_system(x, box, rc, charges=None):
    """A System of len(x) LJ sites with no bonds, exclusions or waters."""
    n = len(x)
    z2 = np.zeros((0, 2), np.int64)
    arrays = dict(
        masses=np.ones(n), charges=np.zeros(n) if charges is None
        else np.asarray(charges), lj_sigma=np.full(n, 3.0),
        lj_eps=np.full(n, 0.1), atom_mask=np.ones(n), dof_mask=np.ones(n),
        bond_idx=z2, bond_k=np.zeros(0), bond_r0=np.zeros(0),
        angle_idx=np.zeros((0, 3), np.int64), angle_k=np.zeros(0),
        angle_theta0=np.zeros(0), dihedral_idx=np.zeros((0, 4), np.int64),
        dihedral_k=np.zeros(0), dihedral_n=np.zeros(0),
        dihedral_phase=np.zeros(0), excl_idx=z2, excl_mask=np.zeros(0),
        pair14_idx=z2, pair14_mask=np.zeros(0), pair14_scee=np.zeros(0),
        pair14_scnb=np.zeros(0), vsite_idx=np.zeros((0, 4), np.int64),
        vsite_weight=np.zeros(0), vsite_mask=np.zeros(0),
        hcluster_heavy=np.zeros(0, np.int64),
        hcluster_h=np.zeros((0, 3), np.int64),
        hcluster_r0=np.zeros((0, 3)))
    md = {"lj_cutoff": rc, "coulomb_cutoff": rc, "ewald_rtol": 1e-5,
          "pme_grid": [8, 8, 8], "temp_target": 300.0,
          "integrator": ["langevin_middle", {"gamma": 1.0}],
          "hydrogen_constraint": ["flexible", {}]}
    statics = {"water_count": 0}
    return System(arrays, statics, [box] * 3, md, "cpu")


def test_pair_count_by_hand():
    # box 10, rc 4: (0,1) 3.0 apart; (0,2) 9.5 apart = 0.5 through the face;
    # (1,2) 6.5 apart = 3.5 through the face; (0,3) and the rest far
    x = np.array([[0.5, 5.0, 5.0], [3.5, 5.0, 5.0], [10.0, 5.0, 5.0],
                  [5.0, 0.0, 0.0]])
    sys_ = bare_system(x, 10.0, 4.0)
    pairs = sys_.count_pairs(torch.as_tensor(x))
    # by hand: (0,1) 3.0, (0,2) 0.5, (1,2) 3.5 in; site 3 is 7.1 or more
    # from each
    assert pairs == 3


def test_direct_pair_energy_by_hand():
    x = np.array([[1.0, 1.0, 1.0], [4.0, 1.0, 1.0]])
    sys_ = bare_system(x, 20.0, 9.0, charges=[0.5, -0.5])
    xt = torch.as_tensor(x, dtype=torch.float64)
    e = float(sys_._direct(xt, torch.tensor([[0, 1]])))
    r = 3.0
    s6 = (3.0 / r) ** 6
    e_lj = 4 * 0.1 * (s6 * s6 - s6)
    e_c = 332.0637128 * -0.25 * math.erfc(sys_.beta * r) / r
    assert e == pytest.approx(e_lj + e_c, rel=1e-12)


def test_k2_and_pme_counts_by_hand():
    assert counts.direct_ops(3) == 3 * 88
    # 2 charged sites on an 8^3 mesh: spread 2 x 216 and gather 6 x 216 per
    # site; two real transforms of 512 points, 2.5 x 512 x 9 each
    pme = 2 * 8 * 216 + 2 * 2.5 * 512 * 9
    assert counts.pme_ops(2, (8, 8, 8)) == pme
    assert counts.farm_step_ops(2, 3, 2, (8, 8, 8)) == 2 * 2 * (264 + pme)
    assert counts.direct_bytes(10) == 10 * 36
    assert counts.roofline_ms(67e9, 1.0) == pytest.approx(1.0)
    assert counts.roofline_ms(1.0, 3.35e9) == pytest.approx(1.0)
