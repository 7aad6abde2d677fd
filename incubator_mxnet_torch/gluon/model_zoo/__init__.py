"""Model zoo of the port."""
from . import bert
from . import transformer
from . import vision
from .bert import BERTModel, BERTForPretrain, bert_base, bert_large
from .transformer import (Transformer, beam_search, greedy_search, transformer_base,
                          transformer_big, transformer_sharding_rules)

__all__ = ["bert", "transformer", "vision", "BERTModel", "BERTForPretrain", "bert_base",
           "bert_large", "Transformer", "transformer_base", "transformer_big",
           "transformer_sharding_rules", "greedy_search", "beam_search"]
