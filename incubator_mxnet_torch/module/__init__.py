"""``mx.mod`` / ``mx.module`` namespace (parity: [U:python/mxnet/module/]),
the counterpart of the JAX package's ``module/``."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
