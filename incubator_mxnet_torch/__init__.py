"""incubator_mxnet_torch: the MXNet 1.x surface of the JAX package,
ported to PyTorch and hand-written CUDA kernels for one NVIDIA H100.

Conventional import:  ``import incubator_mxnet_torch as mx``.  Entry points
run on the card unless the caller asks for the CPU: the default context is
``mx.gpu(0)``, and ``ctx=mx.cpu()`` selects the CPU.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError, DeferredInitializationError
from .context import Context, cpu, gpu, current_context, num_gpus
from . import context
from . import autograd
from . import random
from . import initializer
from . import initializer as init
from . import ops
from .ops.registry import nd
from . import optimizer
from . import gluon
from . import convert

__all__ = ["MXNetError", "DeferredInitializationError", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "context", "autograd", "random",
           "initializer", "init", "ops", "nd", "optimizer", "gluon", "convert"]
