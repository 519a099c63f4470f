"""Run one function on N spawned processes that form a torch.distributed
group.

    results = run_ranks(fn, n, "gloo", "cuda", args)

calls fn(rank, n, device, *args) on each rank and returns the ranks'
results in rank order. On "cuda", rank r runs on card r % (number of
cards), so all ranks share the card where there is one. The start method
is `spawn`, because the parent may already hold a CUDA context, which a
forked child cannot use. The ranks meet through a FileStore in a fresh
temporary directory, so two runs on one machine never contend for a TCP
port; each result travels back through that directory (torch.save) and
must be picklable, with its tensors on the CPU. A rank that raises fails
the whole run: the spawn join raises in the parent and stops the other
ranks.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch

from ..device import resolve_device


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: "cuda" without an index spreads the ranks
    over the cards (rank % device count; one card takes them all)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def run_ranks(fn, n: int, backend: str, device, args=()):
    """Run fn(rank, n, device, *args) on n processes over `backend`
    ("gloo" or "nccl") with the ranks on `device` ("cpu" or "cuda", see
    rank_device) and return the results in rank order. `fn` must be a
    module-level function (the children import it)."""
    import torch.multiprocessing as mp

    devices = [str(rank_device(device, r)) for r in range(n)]
    if backend == "nccl" and len(set(devices)) < n:
        raise ValueError("nccl takes one card per rank; several ranks on "
                         "one card run over gloo")
    tmp = tempfile.mkdtemp(prefix="molchanica_ranks_")
    try:
        mp.start_processes(
            _rank_main, args=(fn, n, backend, devices, tuple(args), tmp),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# a collective that waits longer than this fails its rank, and the run
TIMEOUT = datetime.timedelta(seconds=600)


def _rank_main(rank, fn, n, backend, devices, args, tmp):
    import torch.distributed as dist

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    try:
        out = fn(rank, n, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
