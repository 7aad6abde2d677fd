"""Operators of the port: plain PyTorch functions, and the hand-written
CUDA kernels' wrappers (``attention.flash_fwd``, ``attention.flash_bwd``,
``bn.bn_stats``, ``bn.bn_apply``, ``bn.bn_apply_res``)."""
from . import registry, tensor, nn, random_ops, attention, bn, optimizer_ops, detection, rnn_ops  # noqa: F401,E501  (registers the ops)
from . import spatial, linalg, quantization, control_flow  # noqa: F401  (registers the ops)
