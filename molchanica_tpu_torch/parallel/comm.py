"""Transport between the processes of one torch.distributed group.

NCCL moves device tensors directly. Any other backend (gloo) moves host
tensors, so this module stages device tensors through host memory
explicitly: a copy to the CPU before a send, a copy to the rank's device
after a receive. Several ranks sharing one card run over gloo, because
NCCL refuses two ranks on one GPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device


class Comm:
    """Ring exchanges and collectives of `group` (None: the default group)
    for tensors on `device` (None: the CUDA card; raises without one)."""

    def __init__(self, group=None, device=None):
        self.device = resolve_device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.staged = self.backend != "nccl"

    def _wire(self, t):
        t = t.detach().contiguous()
        return t.cpu() if self.staged else t

    def _buf(self, like):
        return torch.empty(tuple(like.shape), dtype=like.dtype,
                           device="cpu" if self.staged else self.device)

    def _peer(self, r):
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def exchange(self, sends, recvs):
        """Post every send [(peer, tensor)] and receive [(peer, tensor
        shaped like the message)] of this rank at once and wait; returns
        the received tensors on this rank's device. Messages between two
        ranks pair up in the order they are posted on each side (NCCL
        matches by order; the tags make gloo do the same)."""
        ops, bufs = [], []
        n_sent, n_recv = {}, {}
        for peer, t in sends:
            tag = n_sent[peer] = n_sent.get(peer, -1) + 1
            ops.append(dist.P2POp(dist.isend, self._wire(t),
                                  self._peer(peer), self.group, tag))
        for peer, like in recvs:
            tag = n_recv[peer] = n_recv.get(peer, -1) + 1
            bufs.append(self._buf(like))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], self._peer(peer),
                                  self.group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(self.device) for b in bufs]

    def all_reduce(self, t):
        """Sum over the group."""
        w = self._wire(t).clone()
        dist.all_reduce(w, group=self.group)
        return w.to(self.device)

    def all_gather(self, t):
        """The ranks' tensors (all of one shape) stacked along dim 0."""
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(out, w, group=self.group)
        return torch.cat(out).to(self.device)
