"""Host-side pair lists for the nonbonded terms (port of
molchanica_tpu.ops.nonbonded.intramol_pairs_np)."""
from __future__ import annotations

import numpy as np


def intramol_pairs_np(top, max_coupled: int = 2048):
    """Non-excluded, non-1-4 pairs internal to the coupled molecule, as
    (int32 [P, 2], float32 mask [P]); P >= 1, padded with (0, 0) mask 0.

    They appear in the PME reciprocal sum with couple^2-scaled charges but
    stay at full strength at every lambda (GROMACS couple-intramol=no)."""
    def a(t):
        return t.detach().cpu().numpy()

    cm = a(top.couple_mask) * a(top.atom_mask)
    coupled = np.where(cm > 0)[0]
    empty = (np.zeros((1, 2), np.int32), np.zeros((1,), np.float32))
    if coupled.size == 0:
        return empty
    if coupled.size > max_coupled:
        raise ValueError(
            f"coupled molecule too large ({coupled.size} atoms) for the "
            "intramolecular compensation pair list")
    skip = set()
    for idx, m in ((a(top.excl_idx), a(top.excl_mask)),
                   (a(top.pair14_idx), a(top.pair14_mask))):
        for (i, j), mm in zip(idx, m):
            if mm > 0:
                skip.add((min(int(i), int(j)), max(int(i), int(j))))
    pairs = [(int(coupled[p]), int(coupled[q]))
             for p in range(coupled.size)
             for q in range(p + 1, coupled.size)
             if (int(coupled[p]), int(coupled[q])) not in skip]
    if not pairs:
        return empty
    return (np.asarray(pairs, np.int32), np.ones((len(pairs),), np.float32))
