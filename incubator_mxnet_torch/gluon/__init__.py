"""Gluon: the imperative front end of the port."""
from . import parameter
from .parameter import Parameter, Constant, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import loss
from . import model_zoo
from . import trainer
from .trainer import Trainer
from . import data

__all__ = ["Parameter", "Constant", "ParameterDict", "Block", "HybridBlock", "SymbolBlock", "nn",
           "loss", "model_zoo", "Trainer", "data"]
