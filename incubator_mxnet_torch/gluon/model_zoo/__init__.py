"""Model zoo of the port."""
from . import bert
from . import ssd
from . import transformer
from . import vision
from . import yolo
from .bert import BERTModel, BERTForPretrain, bert_base, bert_large
from .ssd import SSD, ssd_512_resnet18, ssd_512_vgg16_atrous
from .transformer import (Transformer, beam_search, greedy_search, transformer_base,
                          transformer_big, transformer_sharding_rules)
from .vision import get_model
from .yolo import YOLOV3, DarknetV3, yolo3_darknet53

__all__ = ["bert", "ssd", "transformer", "vision", "yolo", "get_model", "BERTModel",
           "BERTForPretrain", "bert_base", "bert_large", "SSD", "ssd_512_resnet18",
           "ssd_512_vgg16_atrous", "Transformer", "transformer_base", "transformer_big",
           "transformer_sharding_rules", "greedy_search", "beam_search", "YOLOV3",
           "DarknetV3", "yolo3_darknet53"]
