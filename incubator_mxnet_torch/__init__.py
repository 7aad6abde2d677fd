"""incubator_mxnet_torch: the MXNet 1.x surface of the JAX package,
ported to PyTorch and hand-written CUDA kernels for one NVIDIA H100.

Conventional import:  ``import incubator_mxnet_torch as mx``.  Entry points
run on the card unless the caller asks for the CPU: the default context is
``mx.gpu(0)``, and ``ctx=mx.cpu()`` selects the CPU.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError, DeferredInitializationError
from .context import Context, cpu, gpu, cpu_pinned, current_context, num_gpus
from . import context
from . import autograd
from . import random
from . import initializer
from . import initializer as init
from . import ops
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import optimizer
from . import lr_scheduler
from . import gluon
from . import amp
from . import convert
from . import operator
from . import rtc
from . import name
from . import attribute
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .executor import Executor
from . import profiler
from . import predictor
from . import serving
from . import kvstore
from . import kvstore as kv
from . import parallel
from . import recordio
from . import io
from . import image
from . import metric
from . import callback
from . import model
from . import module
from . import module as mod
from . import rnn
from . import monitor
from .monitor import Monitor
from . import contrib

__all__ = ["MXNetError", "DeferredInitializationError", "Context", "cpu", "gpu", "cpu_pinned",
           "current_context", "num_gpus", "context", "autograd", "random",
           "initializer", "init", "ops", "nd", "ndarray", "NDArray", "optimizer", "lr_scheduler", "gluon", "amp", "convert", "operator",
           "rtc", "name", "attribute", "AttrScope", "symbol", "sym", "Executor", "profiler",
           "predictor", "serving", "kvstore", "kv", "parallel", "recordio", "io", "image", "metric", "callback", "model", "module", "mod", "rnn",
           "monitor", "Monitor", "contrib"]
