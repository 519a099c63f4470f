"""Parallel execution (port of molchanica_tpu.parallel): independent
replicas as batched tensors, and one simulation split over the processes
of a torch.distributed group.

  - replicas.py: ReplicaFarm, R copies of one MdSim advanced in lockstep
    with a leading replica axis, cut over devices;
  - spatial.py: x-slab decomposition with halo exchange over the ring
    (the dense prototype, with a replicated-grid PME);
  - spatial_colpair.py: the colpair kernel sharded over blocks of the
    sorted slots, halo exchange and halo force reduce;
  - launch.py: spawns the ranks; comm.py: the transport (NCCL moves
    device tensors, gloo stages them through host memory);
  - dryrun.py: all of it end to end at a small size (the replica TI in
    one process, the spatial paths over ranks).
"""
from .replicas import ReplicaFarm  # noqa: F401
from .spatial import make_spatial_force_fn, partition_slabs  # noqa: F401
