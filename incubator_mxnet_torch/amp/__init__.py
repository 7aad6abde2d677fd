"""``mx.amp`` namespace (parity: [U:python/mxnet/contrib/amp/])."""
from .amp import (init, is_enabled, disable, disabled, convert_symbol, convert_model, LossScaler,
                  scale_loss, init_trainer, unscale, convert_hybrid_block, list_lp16_ops,
                  list_fp32_ops)
from . import lists

__all__ = ["init", "is_enabled", "disable", "disabled", "convert_symbol", "convert_model",
           "LossScaler", "scale_loss", "init_trainer", "unscale", "convert_hybrid_block",
           "list_lp16_ops", "list_fp32_ops", "lists"]
