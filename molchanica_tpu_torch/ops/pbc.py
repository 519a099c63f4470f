"""Periodic-boundary displacement and wrapping for orthorhombic boxes.

torch.round rounds half to even, as jnp.round does.
"""
from __future__ import annotations

import torch


def minimum_image(dx, box):
    """dx: (..., 3) raw displacement; box: (3,) extent or None (vacuum)."""
    if box is None:
        return dx
    return dx - box * torch.round(dx / box)


def displacement(xi, xj, box):
    """xi - xj under minimum image."""
    return minimum_image(xi - xj, box)


def wrap(x, box):
    """Wrap positions into [0, box) per axis."""
    if box is None:
        return x
    return x - box * torch.floor(x / box)
