"""Optimizers of the port (parity: ``mx.optimizer``)."""
from .optimizer import SGD, Adam, Optimizer, Updater, create, get_updater, register
from . import fused

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create", "register", "fused"]
