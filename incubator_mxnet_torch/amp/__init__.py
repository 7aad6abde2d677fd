"""``mx.amp`` namespace (parity: [U:python/mxnet/contrib/amp/])."""
from .amp import init, is_enabled, disable, disabled, convert_symbol, convert_model
from . import lists

__all__ = ["init", "is_enabled", "disable", "disabled", "convert_symbol", "convert_model",
           "lists"]
