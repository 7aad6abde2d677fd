"""Operators of the port: plain PyTorch functions, and the hand-written
CUDA kernels' wrappers (``attention.flash_fwd``, ``attention.flash_bwd``)."""
from . import registry, tensor, nn, attention, optimizer_ops  # noqa: F401  (registers the ops)
