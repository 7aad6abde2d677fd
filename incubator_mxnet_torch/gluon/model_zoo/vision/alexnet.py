"""AlexNet (parity: [U:python/mxnet/gluon/model_zoo/vision/alexnet.py]).

Counterpart of the JAX package's ``vision/alexnet.py``, with the same
parameter structure, so weights carry across by structural key."""
from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not downloaded; load them with "
                           "convert.load_numpy_params")
    return net
