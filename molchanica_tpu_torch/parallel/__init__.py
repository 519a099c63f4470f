"""Parallel execution: one simulation split over the processes of a
torch.distributed group (port of molchanica_tpu.parallel's spatial
modules; the replica farm is not ported yet).

  - spatial.py: x-slab decomposition with halo exchange over the ring
    (the dense prototype, with a replicated-grid PME);
  - spatial_colpair.py: the colpair kernel sharded over blocks of the
    sorted slots, halo exchange and halo force reduce;
  - launch.py: spawns the ranks; comm.py: the transport (NCCL moves
    device tensors, gloo stages them through host memory);
  - dryrun.py: all of it end to end at a small size.
"""
from .spatial import make_spatial_force_fn, partition_slabs  # noqa: F401
