"""Model zoo of the port."""
from . import bert
from . import vision
from .bert import BERTModel, BERTForPretrain, bert_base, bert_large

__all__ = ["bert", "vision", "BERTModel", "BERTForPretrain", "bert_base", "bert_large"]
