"""Spatial decomposition of one simulation: the colpair kernel sharded over
the processes of a torch.distributed group (port of
molchanica_tpu.parallel.spatial_colpair).

The sorted slot array is split into equal contiguous blocks, one per
rank. Each rank runs the triangular kernel over its own clusters (the
shard variant, K1f) against a local j array of its block plus `halo`
blocks on each side, received from its ring neighbours; the j reactions
that land in halo slots go back to the blocks' owners and are summed
there, and the energies are summed over the group.

Why this is exact: slot space is ordered by (xy column, z), so a
cluster's window entries are contiguous global slot ranges, and the
periodic x/y wrap is the wrap of slot space, which the ring reproduces
(rank 0's left halo is the top of slot space). The window table is the
single-device range table with its entries moved to local slots (one
subtraction mod S), so the kernel runs the same tiles per cluster as on
one device. The rebuild (sort, tables, halo depth) stays replicated on
every rank.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.colpair import ICL, ColPlan, ColpairDirect
from .comm import Comm


def pad_plan_for_mesh(plan: ColPlan, n_dev: int) -> ColPlan:
    """Round n_sorted up so it splits into n_dev blocks of whole clusters
    (each block a multiple of ICL and of 128 slots)."""
    blk = n_dev * int(np.lcm(ICL, 128))
    s2 = int(math.ceil(plan.n_sorted / blk) * blk)
    if s2 == plan.n_sorted:
        return plan
    return dataclasses.replace(plan, n_sorted=s2)


def halo_depth_for(plan: ColPlan, n_dev: int, wl, nw) -> int:
    """Smallest halo depth (blocks per side) that covers every window
    entry of every cluster, in ring distance from the cluster's block.
    Host numpy, once per rebuild."""
    B = plan.n_sorted // n_dev
    NC = plan.n_clusters
    w3 = np.asarray(wl).reshape(NC, -1, 3).astype(np.int64)
    nw = np.asarray(nw).astype(np.int64)
    lo, hi = w3[..., 0], w3[..., 1]
    used = (np.arange(w3.shape[1])[None, :] < nw[:, None]) & (hi > lo)
    if not used.any():
        return 0
    own = (np.arange(NC) * ICL // B)[:, None]
    d = np.abs(np.stack([lo, hi - 1]) // B - own)
    return int(np.minimum(d, n_dev - d)[:, used].max())


class ShardedColpair:
    """The colpair direct sum of one sorted state on every rank of `group`:
    sharded_direct(rows [B, 8], wl [NCl, 3 w_max], nw [NCl], box, couple)
    -> (f [B, 3], e_lj, e_c), this rank's block of the rows, of the range
    table (global slots) and of the forces; the energies are the totals.
    S and NC must split into the group's size (pad_plan_for_mesh).
    Tensors live on `device` (None: the CUDA card; raises without one)."""

    def __init__(self, group, plan: ColPlan, halo: int,
                 has_alch: bool = False, want_energy: bool = True,
                 device=None):
        self.comm = comm = Comm(group, device)
        n_dev, S, NC = comm.size, plan.n_sorted, plan.n_clusters
        if S % n_dev or NC % n_dev:
            raise ValueError(f"{S} slots / {NC} clusters do not split into "
                             f"{n_dev} blocks: pad_plan_for_mesh")
        # the halo may reach the antipode (2 halo + 1 == n_dev + 1): the
        # local j array then holds one block twice
        if 2 * halo + 1 > n_dev + 1:
            raise ValueError(f"halo {halo} exceeds the ring of {n_dev}")
        self.S, self.halo = S, int(halo)
        self.B = B = S // n_dev
        self.NCl = NC // n_dev
        self.s_local = (2 * halo + 1) * B
        self.kernel = ColpairDirect(
            plan, want_energy, has_alch=has_alch, range_tables=True,
            local_shape=(self.NCl, self.s_local, halo * B))

    def _ring(self, per_k):
        """(sends, recvs) for each k = 1..halo: to d + k and d - k the
        tensors per_k(k) gives, from d - k and d + k alike."""
        d, n = self.comm.rank, self.comm.size
        sends, recvs = [], []
        for k in range(1, self.halo + 1):
            to_right, to_left = per_k(k)
            sends += [((d + k) % n, to_right), ((d - k) % n, to_left)]
            recvs += [((d - k) % n, to_left), ((d + k) % n, to_right)]
        return sends, recvs

    def local_inputs(self, rows, wl):
        """(pT [8, s_local], wl in local slots): the own block between
        `halo` blocks on each side, block d - k from rank d - k and block
        d + k from rank d + k; entries moved to local slots."""
        got = self.comm.exchange(*self._ring(lambda k: (rows, rows)))
        h = self.halo
        left = [got[2 * (k - 1)] for k in range(h, 0, -1)]
        right = [got[2 * (k - 1) + 1] for k in range(1, h + 1)]
        pT = torch.cat(left + [rows] + right).T.contiguous()
        # local = global - (d - halo) B, wrapped into [0, S); an entry keeps
        # its length (entries lie inside the halo window: halo_depth_for)
        base = (self.comm.rank - h) * self.B
        w3 = wl.reshape(self.NCl, -1, 3).long()
        lo = torch.remainder(w3[..., 0] - base, self.S)
        hi = lo + (w3[..., 1] - w3[..., 0])
        wl_loc = torch.stack([lo, hi, w3[..., 2]], 2).reshape(self.NCl, -1)
        return pT, wl_loc.to(torch.int32)

    def reduce(self, f_i, f_j, e):
        """(f [B, 3], e_lj, e_c): the own block's i-forces and reactions
        plus the halo reactions sent back by the ranks that computed them;
        e = [e_lj, e_c] of this rank, summed over the group."""
        h, B = self.halo, self.B
        f = f_i + f_j[h * B:(h + 1) * B]
        back = self.comm.exchange(*self._ring(lambda k: (
            f_j[(h + k) * B:(h + k + 1) * B],
            f_j[(h - k) * B:(h - k + 1) * B])))
        for k in range(h):
            f = f + back[2 * k] + back[2 * k + 1]
        e = self.comm.all_reduce(e)
        return f, e[0], e[1]

    def __call__(self, rows, wl, nw, box, couple):
        pT, wl_loc = self.local_inputs(rows, wl)
        f_i, f_j, e_lj, e_c = self.kernel(rows, pT, wl_loc, nw, box, couple)
        return self.reduce(f_i, f_j, torch.stack([e_lj, e_c]))


def make_sharded_colpair_direct(group, plan: ColPlan, halo: int,
                                has_alch: bool = False,
                                want_energy: bool = True, device=None):
    """The sharded direct sum on this rank (see ShardedColpair)."""
    return ShardedColpair(group, plan, halo, has_alch=has_alch,
                          want_energy=want_energy, device=device)


def block(a, rank: int, n_dev: int):
    """Rank `rank`'s block of a global array split along dim 0."""
    m = a.shape[0] // n_dev
    return a[rank * m:(rank + 1) * m]


def _sharded_rank(rank, n_dev, device, plan, halo, rows, wl, nw, box,
                  want_energy):
    direct = make_sharded_colpair_direct(None, plan, halo,
                                         want_energy=want_energy,
                                         device=device)
    to = lambda t: block(t, rank, n_dev).to(device).contiguous()
    f, e_lj, e_c = direct(to(rows), to(wl), to(nw), box.to(device),
                          torch.ones((), device=device))
    f = direct.comm.all_gather(f)
    return f.cpu(), float(e_lj), float(e_c)


def run_sharded_colpair(n_dev: int, backend: str, device, plan: ColPlan,
                        halo: int, rows, wl, nw, box,
                        want_energy: bool = True):
    """Spawn n_dev ranks (parallel/launch.py), hand each its block of the
    global sorted rows [S, 8] and range table, run the sharded direct sum
    and gather the forces: (f [S, 3], e_lj, e_c) on the CPU, as rank 0
    assembled them."""
    from .launch import run_ranks

    args = (plan, int(halo), rows.cpu(), wl.cpu(), nw.cpu(), box.cpu(),
            bool(want_energy))
    return run_ranks(_sharded_rank, n_dev, backend, device, args)[0]
