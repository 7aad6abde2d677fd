"""Vision model zoo of the port (parity:
[U:python/mxnet/gluon/model_zoo/vision/]): the ResNets, AlexNet, VGG,
MobileNet V1/V2, SqueezeNet, DenseNet and Inception V3, the 34 names of
the JAX package's ``get_model``.  No weights are downloaded: carry them in
with ``convert.load_numpy_params``."""
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2, BottleneckV1,
                     BottleneckV2, resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
                     resnet152_v2, get_resnet)
from .alexnet import AlexNet, alexnet
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn
from .mobilenet import (MobileNet, MobileNetV2, mobilenet1_0, mobilenet0_75, mobilenet0_5,
                        mobilenet0_25, mobilenet_v2_1_0, mobilenet_v2_0_75, mobilenet_v2_0_5,
                        mobilenet_v2_0_25)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import DenseNet, densenet121, densenet161, densenet169, densenet201
from .inception import Inception3, inception_v3

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
    "alexnet": alexnet,
    "vgg11": vgg11,
    "vgg13": vgg13,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "vgg11_bn": vgg11_bn,
    "vgg13_bn": vgg13_bn,
    "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "mobilenet1.0": mobilenet1_0,
    "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5,
    "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0,
    "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121,
    "densenet161": densenet161,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """Parity: ``model_zoo.vision.get_model``."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["get_model", "get_resnet", "ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "AlexNet", "VGG", "MobileNet", "MobileNetV2",
           "SqueezeNet", "DenseNet", "Inception3"] + sorted(f.__name__ for f in _models.values())
