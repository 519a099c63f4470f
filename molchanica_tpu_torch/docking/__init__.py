"""Docking: batched rigid-receptor pose scoring and MD shooting (port of
molchanica_tpu.docking).

Reference design: src/docking/legacy (DockingSetup precompute, init_poses
grid x orientation x torsion enumeration, process_poses clash-cull + scoring,
calc_binding_energy weighted score — SURVEY.md §2.3). Site finding and pose
enumeration are numpy on the host; the setup's fields and the scorer's
[B, L, R] batches are torch tensors on the device.
"""
from .site import DockingSite, find_sites  # noqa: F401
from .setup import DockingSetup  # noqa: F401
from .poses import init_poses  # noqa: F401
from .scorer import BindingEnergy, score_poses, find_optimal_pose  # noqa: F401
