"""Vision model zoo of the port: the ResNets (parity:
[U:python/mxnet/gluon/model_zoo/vision/])."""
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2, BottleneckV1,
                     BottleneckV2, resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
                     resnet152_v2, get_resnet)

_models = {
    "resnet18_v1": resnet18_v1,
    "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1,
    "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """Parity: ``model_zoo.vision.get_model``."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["get_model", "get_resnet", "ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2"] + sorted(_models)
