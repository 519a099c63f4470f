"""PyTorch/CUDA port of molchanica_tpu.

The package imports torch, numpy and scipy only. Its entry points run on
the CUDA device unless the caller passes ``device="cpu"``; with no CUDA
device they raise instead of falling back (see ``resolve_device``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
