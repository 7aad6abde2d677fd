"""SSD single-shot detector (parity: the reference's SSD example family,
[U:example/ssd/symbol/], BASELINE.md config 5).

Counterpart of the JAX package's ``gluon/model_zoo/ssd.py``, with the same
parameter structure, so weights carry across by structural key.  Every
stage is fixed-shape: the anchors come from ``contrib_MultiBoxPrior``,
built on the feature map's device from its shape (nothing is copied from
the host, so the forward runs inside the step fold's CUDA-graph capture),
and the heads' outputs concatenate to one ``[B, N, C+1]`` / ``[B, N·4]``
pair.  Training targets and NMS are the mask-based ops of
:mod:`...ops.detection`.

The forward returns (anchors [1, N, 4], cls_preds [B, N, C+1],
box_preds [B, N·4]), the triple MultiBoxTarget/MultiBoxDetection consume.
"""
from __future__ import annotations

from ..block import HybridBlock
from .. import nn

__all__ = ["SSD", "ssd_512_resnet18", "ssd_512_vgg16_atrous", "SSDAnchorScales"]

# Per-scale (sizes, ratios): the classic SSD512 schedule, normalized.
SSDAnchorScales = [
    ((0.07, 0.1025), (1.0, 2.0, 0.5)),
    ((0.15, 0.2121), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
    ((0.3, 0.3674), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
    ((0.45, 0.5196), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
    ((0.6, 0.6708), (1.0, 2.0, 0.5)),
    ((0.75, 0.8216), (1.0, 2.0, 0.5)),
]


def _n_anchors(sizes, ratios):
    return len(sizes) + len(ratios) - 1


class _DownsampleBlock(HybridBlock):
    """conv1x1 → conv3x3/s2 feature-pyramid step (the example's
    ``_add_extras``)."""

    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 2, kernel_size=1))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=3, strides=2, padding=1))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))

    def hybrid_forward(self, F, x):
        return self.body(x)


class SSD(HybridBlock):
    """Generic SSD over a feature extractor.

    Parameters
    ----------
    features : HybridBlock
        Backbone mapping images → the first (highest-resolution) feature
        map used for prediction.
    num_classes : int
        Foreground classes (background is implicit class 0 of the head).
    scales : list of (sizes, ratios)
        Anchor schedule per pyramid level; levels beyond the backbone map
        are built with stride-2 downsample blocks.
    """

    def __init__(self, features, num_classes, scales=SSDAnchorScales,
                 channels=256, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._scales = list(scales)
        with self.name_scope():
            self.features = features
            self.downsamplers = nn.HybridSequential(prefix="down_")
            for _ in range(len(self._scales) - 1):
                self.downsamplers.add(_DownsampleBlock(channels))
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.box_heads = nn.HybridSequential(prefix="box_")
            for sizes, ratios in self._scales:
                a = _n_anchors(sizes, ratios)
                self.cls_heads.add(nn.Conv2D(a * (num_classes + 1),
                                             kernel_size=3, padding=1))
                self.box_heads.add(nn.Conv2D(a * 4, kernel_size=3, padding=1))

    def hybrid_forward(self, F, x):
        feats = [self.features(x)]
        for down in self.downsamplers.children():
            feats.append(down(feats[-1]))

        anchors, cls_preds, box_preds = [], [], []
        for feat, (sizes, ratios), cls_head, box_head in zip(
                feats, self._scales, self.cls_heads.children(), self.box_heads.children()):
            anchors.append(F.contrib.MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                                   clip=True))
            # [B, A*(C+1), H, W] → [B, H·W·A, C+1]
            c = cls_head(feat).permute(0, 2, 3, 1)
            cls_preds.append(c.reshape(c.shape[0], -1, self.num_classes + 1))
            b = box_head(feat).permute(0, 2, 3, 1)
            box_preds.append(b.reshape(b.shape[0], -1))
        return (F.concat(*anchors, dim=1),
                F.concat(*cls_preds, dim=1),
                F.concat(*box_preds, dim=1))


def ssd_512_resnet18(num_classes=20, **kwargs):
    """SSD-512 with a ResNet-18 feature backbone (stages through conv4)."""
    from .vision.resnet import resnet18_v1

    base = resnet18_v1(classes=1)  # classifier head unused
    features = nn.HybridSequential(prefix="backbone_")
    # the reference keeps everything up to (not incl.) the last stage and
    # the global pool
    for layer in list(base.features.children())[:-2]:
        features.add(layer)
    return SSD(features, num_classes, **kwargs)


def ssd_512_vgg16_atrous(num_classes=20, **kwargs):
    """SSD-512 with the reference's VGG-16 (atrous) backbone
    ([U:example/ssd/symbol/vgg16_reduced.py] / GluonCV
    ssd_512_vgg16_atrous): conv1_1..conv5_3 with the third maxpool
    ceil-rounded, pool5 3×3/1, and fc6 as a dilated 1024-channel conv +
    fc7 1×1; no BatchNorm in the backbone (the SSD's downsamplers hold 10)."""
    from ..nn import Conv2D, MaxPool2D

    layers, filters = [2, 2, 3, 3, 3], [64, 128, 256, 512, 512]
    features = nn.HybridSequential(prefix="vggbackbone_")
    for i, num in enumerate(layers):
        for _ in range(num):
            features.add(Conv2D(filters[i], kernel_size=3, padding=1,
                                activation="relu"))
        if i < len(layers) - 1:  # pool1..pool4 stride 2; pool5 below
            # pool3 ceil-rounds in the reference (75->38 at 300-input)
            features.add(MaxPool2D(pool_size=2, strides=2, ceil_mode=(i == 2)))
    # pool5: 3x3 stride 1 (keeps conv5 resolution for the atrous fc6)
    features.add(MaxPool2D(pool_size=3, strides=1, padding=1))
    # fc6: dilated conv (atrous trick), fc7: 1x1 conv
    features.add(Conv2D(1024, kernel_size=3, padding=6, dilation=6,
                        activation="relu"))
    features.add(Conv2D(1024, kernel_size=1, activation="relu"))
    return SSD(features, num_classes, **kwargs)
