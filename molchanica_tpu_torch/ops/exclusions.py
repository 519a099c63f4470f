"""The excluded and 1-4 pairs of a topology as one table that every
direct-space backend of MdSim looks its pairs up in, so that those pairs
never enter the direct space (the rest energy adds what they do carry: the
Ewald exclusion correction and the scaled 1-4 terms).

The table is a bitmask per site over the sites after it: bit (d - 1) % 32
of word (d - 1) // 32 of row i is set where sites i and i + d form a pair
of `excl_idx` or `pair14_idx` (masked rows left out), for 1 <= d <= W. W,
the table's reach, is the largest |i - j| over those pairs rounded up to a
multiple of 32 (32 without any). A pair (a, b) is excluded iff
1 <= |a - b| <= W and bit |a - b| - 1 of row min(a, b) is set: one load
per pair, whatever the topology. The rows are int32 words, laid out as
K2 (csrc/direct_force.cu) and the cluster kernel (csrc/cluster_force.cu)
read them; the cluster list's rebuild flags its entries from the pairs
themselves (`pairs`), so that the cluster kernel looks up only the pairs
of a flagged entry (ops/clusters.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Exclusions:
    bits: torch.Tensor   # [N, W / 32] int32
    pairs: torch.Tensor  # [P, 2] int64, i < j, each pair once

    @staticmethod
    def empty(n: int, device=None) -> "Exclusions":
        """A table of n sites that excludes no pair."""
        return Exclusions(torch.zeros((n, 1), dtype=torch.int32,
                                      device=device),
                          torch.zeros((0, 2), dtype=torch.int64,
                                      device=device))

    @property
    def words(self) -> int:
        return int(self.bits.shape[1])

    def to(self, device) -> "Exclusions":
        return Exclusions(self.bits.to(device), self.pairs.to(device))

    def excluded(self, a, b):
        """Whether each site pair (a, b) is excluded: a bool tensor of the
        broadcast shape of the int64 index tensors a and b (indices below
        0, such as empty slots, read as not excluded). Works under
        torch.func.vmap."""
        lo = torch.minimum(a, b)
        d = torch.abs(a - b) - 1
        reach = (d >= 0) & (d < 32 * self.words) & (lo >= 0)
        d = torch.where(reach, d, torch.zeros_like(d))
        lo = torch.where(reach, lo, torch.zeros_like(lo))
        word = self.bits[lo, d >> 5].to(torch.int64)
        return reach & (((word >> (d & 31)) & 1) != 0)


def exclusion_pairs(top) -> np.ndarray:
    """[P, 2] int64 (i < j): the unmasked pairs of excl_idx and pair14_idx,
    each once."""
    rows = []
    for idx, mask in ((top.excl_idx, top.excl_mask),
                      (top.pair14_idx, top.pair14_mask)):
        idx = np.asarray(torch.as_tensor(idx).cpu(), np.int64).reshape(-1, 2)
        keep = np.asarray(torch.as_tensor(mask).cpu()).reshape(-1) > 0
        rows.append(idx[keep])
    p = np.concatenate(rows)
    p = np.sort(p, axis=1)
    p = p[p[:, 0] != p[:, 1]]
    return np.unique(p, axis=0)


def exclusion_table(top) -> Exclusions:
    """The topology's table, on the device of its tensors."""
    n = int(top.atom_mask.shape[0])
    p = exclusion_pairs(top)
    d = p[:, 1] - p[:, 0] - 1
    words = max(1, -(-(int(d.max()) + 1) // 32)) if len(p) else 1
    bits = np.zeros((n, words), np.uint32)
    np.bitwise_or.at(bits, (p[:, 0], d >> 5),
                     np.left_shift(np.uint32(1), (d & 31).astype(np.uint32)))
    dev = top.atom_mask.device
    return Exclusions(torch.as_tensor(bits.view(np.int32), device=dev),
                      torch.as_tensor(p, device=dev))
