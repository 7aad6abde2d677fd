"""Optimizers of the port (parity: ``mx.optimizer``)."""
from .optimizer import (SGD, NAG, Adam, AdamW, AdaGrad, AdaDelta, RMSProp, Ftrl, Signum, LAMB,
                        Nadam, FTML, SGLD, DCASGD, Adamax, LBSGD, LARS, GroupAdaGrad, Optimizer,
                        Updater, create, get_updater, register)
from . import fused

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "Signum", "LAMB", "Nadam", "FTML", "SGLD", "DCASGD", "Adamax", "LBSGD", "LARS",
           "GroupAdaGrad", "Updater", "get_updater", "create", "register", "fused"]
