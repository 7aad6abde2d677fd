"""Gluon: the imperative front end of the port."""
from . import parameter
from .parameter import Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import model_zoo
from . import trainer
from .trainer import Trainer

__all__ = ["Parameter", "ParameterDict", "Block", "HybridBlock", "nn", "loss", "model_zoo",
           "Trainer"]
