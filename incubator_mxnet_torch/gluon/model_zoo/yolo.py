"""YOLOv3 (parity: the reference ecosystem's YOLOv3-darknet53, the
detection family paired with SSD-512; the reference's own detection path
is [U:example/ssd/] plus the YOLO augmenters of
[U:python/mxnet/image/detection.py]).

Counterpart of the JAX package's ``gluon/model_zoo/yolo.py``, with the same
parameter structure, so weights carry across by structural key.  Every
stage is fixed-shape: the per-scale decode tables (grid offsets, anchor
sizes, strides) depend only on the feature shapes, so they are built once
per shape, scale and device with torch ops on that device and reused by
every later forward: no host copy happens in a step, and a step runs
inside the step fold's CUDA-graph capture.  Predictions concatenate to one
``[B, N, 5+C]`` tensor, decoding is elementwise, NMS is ``box_nms``.

:func:`yolo3_targets` is the dense best-anchor assignment: the IoU of
every (padded) ground-truth box against every anchor prior, argmax over
the priors, a static-shape form of the reference's dynamic matcher.
``yolo3_decode``, ``yolo3_targets`` and ``yolo3_loss`` run on ``mx.nd``
under its currency rule: NDArrays in give NDArrays, tensors give tensors.
"""
from __future__ import annotations

import torch

from ..block import HybridBlock
from .. import nn

__all__ = ["DarknetV3", "DarknetBasicBlockV3", "YOLODetectionBlockV3", "YOLOV3",
           "yolo3_darknet53", "yolo3_decode", "yolo3_targets", "yolo3_loss",
           "Yolo3DefaultAnchors"]

# The canonical COCO anchor schedule (pixels, for a 416 input), small→large
# stride scales (strides 8/16/32 bottom-up).
Yolo3DefaultAnchors = [
    [(10, 13), (16, 30), (33, 23)],       # stride 8
    [(30, 61), (62, 45), (59, 119)],      # stride 16
    [(116, 90), (156, 198), (373, 326)],  # stride 32
]
Yolo3Strides = [8, 16, 32]


def _conv2d(channel, kernel, padding, stride):
    """conv → BN → LeakyReLU(0.1), the darknet unit."""
    cell = nn.HybridSequential(prefix="")
    cell.add(nn.Conv2D(channel, kernel_size=kernel, strides=stride,
                       padding=padding, use_bias=False))
    cell.add(nn.BatchNorm(epsilon=1e-5, momentum=0.9))
    cell.add(nn.LeakyReLU(0.1))
    return cell


class DarknetBasicBlockV3(HybridBlock):
    """1×1 bottleneck + 3×3, residual add."""

    def __init__(self, channel, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(_conv2d(channel // 2, 1, 0, 1))
            self.body.add(_conv2d(channel, 3, 1, 1))

    def hybrid_forward(self, F, x):
        return x + self.body(x)


class DarknetV3(HybridBlock):
    """Darknet-53 backbone: stem + 5 stages of [1, 2, 8, 8, 4] residual
    blocks; the forward returns the last 3 stages (strides 8/16/32)."""

    def __init__(self, layers=(1, 2, 8, 8, 4),
                 channels=(64, 128, 256, 512, 1024), **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stages = nn.HybridSequential(prefix="")
            stem = nn.HybridSequential(prefix="")
            stem.add(_conv2d(32, 3, 1, 1))
            self.stages.add(stem)
            for nlayer, channel in zip(layers, channels):
                stage = nn.HybridSequential(prefix="")
                stage.add(_conv2d(channel, 3, 1, 2))  # stride-2 entry
                for _ in range(nlayer):
                    stage.add(DarknetBasicBlockV3(channel))
                self.stages.add(stage)

    def hybrid_forward(self, F, x):
        outs = []
        for i, stage in enumerate(self.stages.children()):
            x = stage(x)
            if i >= 3:  # stages at stride 8, 16, 32
                outs.append(x)
        return tuple(outs)


class YOLODetectionBlockV3(HybridBlock):
    """5-conv body → ``route`` (lateral, c) and ``tip`` (3×3, 2c)."""

    def __init__(self, channel, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            for _ in range(2):
                self.body.add(_conv2d(channel, 1, 0, 1))
                self.body.add(_conv2d(channel * 2, 3, 1, 1))
            self.body.add(_conv2d(channel, 1, 0, 1))
            self.tip = _conv2d(channel * 2, 3, 1, 1)

    def hybrid_forward(self, F, x):
        route = self.body(x)
        return route, self.tip(route)


def _decode_tables(h, w, anchors, stride, device):
    """The float32 decode tables of one scale, built on ``device``:
    offsets [1, H·W·A, 2] (x, y of the cell), anchors [1, H·W·A, 2],
    strides [1, H·W·A, 1]."""
    na = len(anchors)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).reshape(h * w, 1, 2).expand(h * w, na, 2)
    anc = torch.empty((h * w, na, 2), dtype=torch.float32, device=device)
    for j, (aw, ah) in enumerate(anchors):  # fills from host scalars: no copy
        anc[:, j, 0] = float(aw)
        anc[:, j, 1] = float(ah)
    st = torch.full((1, h * w * na, 1), float(stride), dtype=torch.float32, device=device)
    return grid.reshape(1, -1, 2), anc.reshape(1, -1, 2), st


class YOLOV3(HybridBlock):
    """YOLOv3 with a top-down FPN over 3 backbone scales.

    Forward returns the RAW per-anchor prediction tensor
    ``[B, N, 5 + num_classes]`` (tx, ty, tw, th, obj, cls...) plus the
    static decode tables ``offsets [1, N, 2]``, ``anchors [1, N, 2]``,
    ``strides [1, N, 1]``: feed them to :func:`yolo3_decode` for boxes
    or :func:`yolo3_loss` for training.
    """

    def __init__(self, backbone=None, num_classes=80,
                 anchors=Yolo3DefaultAnchors, strides=Yolo3Strides,
                 channels=(128, 256, 512), **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._anchors = anchors
        self._strides = list(strides)
        # (h, w, scale index, device) → decode tables; the tables are always
        # float32, so the key needs no dtype
        self._table_cache = {}
        na = len(anchors[0])
        with self.name_scope():
            self.backbone = backbone or DarknetV3()
            # top-down order: build blocks for the LARGEST stride first
            self.blocks = nn.HybridSequential(prefix="blk_")
            self.outputs = nn.HybridSequential(prefix="out_")
            self.laterals = nn.HybridSequential(prefix="lat_")
            for i, ch in enumerate(reversed(channels)):
                self.blocks.add(YOLODetectionBlockV3(ch))
                self.outputs.add(nn.Conv2D(na * (5 + num_classes),
                                           kernel_size=1))
                if i < len(channels) - 1:
                    self.laterals.add(_conv2d(ch // 2, 1, 0, 1))

    def hybrid_forward(self, F, x):
        feats = list(self.backbone(x))[::-1]    # top-down: stride 32 first
        strides = self._strides[::-1]
        anchors = self._anchors[::-1]
        na = len(anchors[0])

        all_preds, all_offsets, all_anchors, all_strides = [], [], [], []
        route = None
        blocks = list(self.blocks.children())
        outputs = list(self.outputs.children())
        laterals = list(self.laterals.children())
        for i, feat in enumerate(feats):
            if route is not None:
                up = F.UpSampling(laterals[i - 1](route), scale=2,
                                  sample_type="nearest")
                feat = F.concat(up, feat, dim=1)
            route, tip = blocks[i](feat)
            raw = outputs[i](tip)               # [B, A*(5+C), H, W]
            b, _, h, w = raw.shape
            all_preds.append(raw.permute(0, 2, 3, 1).reshape(b, h * w * na,
                                                             5 + self.num_classes))
            key = (h, w, i, raw.device)
            tables = self._table_cache.get(key)
            if tables is None:
                tables = self._table_cache[key] = _decode_tables(h, w, anchors[i], strides[i],
                                                                 raw.device)
            all_offsets.append(tables[0])
            all_anchors.append(tables[1])
            all_strides.append(tables[2])

        return (F.concat(*all_preds, dim=1),
                F.concat(*all_offsets, dim=1),
                F.concat(*all_anchors, dim=1),
                F.concat(*all_strides, dim=1))


def yolo3_decode(preds, offsets, anchors, strides, num_classes):
    """Raw predictions → ``(ids [B,N,1], scores [B,N,1], boxes [B,N,4])``
    in pixel corner format: the standard v3 decode
    (σ(txy)+grid)·stride, exp(twh)·anchor, σ(obj)·σ(cls)."""
    from ... import ndarray as nd

    txy = nd.slice_axis(preds, axis=-1, begin=0, end=2)
    twh = nd.slice_axis(preds, axis=-1, begin=2, end=4)
    obj = nd.slice_axis(preds, axis=-1, begin=4, end=5)
    cls = nd.slice_axis(preds, axis=-1, begin=5, end=5 + num_classes)

    xy = (nd.sigmoid(txy) + offsets) * strides
    wh = nd.exp(nd.clip(twh, -10, 8)) * anchors
    half = wh * 0.5
    boxes = nd.concat(xy - half, xy + half, dim=-1)
    scores = nd.sigmoid(obj) * nd.sigmoid(cls)          # [B, N, C]
    conf = nd.max(scores, axis=-1, keepdims=True)
    ids = nd.expand_dims(nd.argmax(scores, axis=-1), axis=-1)
    return ids, conf, boxes


def yolo3_targets(gt_boxes, gt_ids, offsets, anchors, strides, num_classes,
                  ignore_thresh=0.7):
    """Dense static-shape target assignment.

    gt_boxes: [B, M, 4] pixel corners, padded rows = -1.
    Returns (obj_t [B,N,1], box_t [B,N,4] raw-space, cls_t [B,N,C],
    masks [B,N,2]): for each valid gt, the prior (grid cell × anchor)
    whose centered anchor box has max IoU gets objectness 1, the encoded
    (tx,ty,tw,th), and the one-hot class.  When several gts pick the same
    prior, the highest-IoU gt wins (never a sum of encodings).
    ``masks[..., 0]`` is the positive mask; ``masks[..., 1]`` weights the
    objectness BCE: 0 for non-positive priors whose IoU with any gt
    exceeds ``ignore_thresh`` (the reference's ignore band, which keeps
    near-hits out of the negative loss)."""
    from ... import ndarray as nd

    B, M, _ = gt_boxes.shape
    N = offsets.shape[1]
    centers = (offsets + 0.5) * strides                  # [1, N, 2]
    half = anchors * 0.5
    priors = nd.concat(centers - half, centers + half, dim=-1)  # [1, N, 4]

    valid = (nd.slice_axis(gt_ids, axis=-1, begin=0, end=1) >= 0)  # [B, M, 1]
    ious = nd.reshape(nd.box_iou(nd.reshape(gt_boxes, (-1, 4)), nd.reshape(priors, (-1, 4))),
                      (B, M, N))
    ious = ious * valid                                  # kill padded rows
    best = nd.argmax(ious, axis=-1)                      # [B, M] prior index

    onehotN = nd.reshape(nd.one_hot(nd.reshape(best, (-1,)), N), (B, M, N))
    onehotN = onehotN * valid                            # [B, M, N]
    obj_t = nd.expand_dims(nd.max(onehotN, axis=1), axis=-1)  # [B, N, 1]

    # crowded-scene tie-break: among gts assigned to a prior, the one with
    # max IoU wins it outright
    winner = nd.argmax(onehotN * ious, axis=1)           # [B, N] gt index
    winner_oh = nd.reshape(nd.one_hot(nd.reshape(winner, (-1,)), M), (B, N, M))
    winner_oh = nd.transpose(winner_oh, axes=(0, 2, 1))  # [B, M, N]
    assign = winner_oh * onehotN                         # ≤1 gt per prior

    # encode each gt in raw space against ITS assigned prior
    gxy = (nd.slice_axis(gt_boxes, axis=-1, begin=0, end=2)
           + nd.slice_axis(gt_boxes, axis=-1, begin=2, end=4)) * 0.5
    gwh = (nd.slice_axis(gt_boxes, axis=-1, begin=2, end=4)
           - nd.slice_axis(gt_boxes, axis=-1, begin=0, end=2))
    strid = nd.reshape(strides, (1, 1, N, 1))
    offs = nd.reshape(offsets, (1, 1, N, 2))
    ancs = nd.reshape(anchors, (1, 1, N, 2))
    txy = nd.reshape(gxy, (B, M, 1, 2)) / strid - offs   # pre-sigmoid target
    txy = nd.clip(txy, 1e-6, 1 - 1e-6)
    twh = nd.log(nd.clip(nd.reshape(gwh, (B, M, 1, 2)) / ancs, 1e-6, 1e6))
    enc = nd.concat(txy, twh, dim=-1)                    # [B, M, N, 4]
    box_t = nd.sum(enc * nd.expand_dims(assign, axis=-1), axis=1)  # [B, N, 4]

    oh_cls = nd.one_hot(nd.clip(nd.reshape(gt_ids, (B, M)), 0, num_classes - 1),
                        num_classes)                     # [B, M, C]
    cls_t = nd.sum(nd.expand_dims(assign, axis=-1)
                   * nd.reshape(oh_cls, (B, M, 1, num_classes)), axis=1)

    # objectness ignore band: non-positive priors overlapping any gt above
    # ignore_thresh contribute nothing to the negative BCE
    max_iou = nd.expand_dims(nd.max(ious, axis=1), axis=-1)  # [B, N, 1]
    obj_w = nd.where(obj_t + (max_iou < ignore_thresh) > 0,
                     nd.ones_like(obj_t), nd.zeros_like(obj_t))
    return obj_t, box_t, cls_t, nd.concat(obj_t, obj_w, dim=-1)


def yolo3_loss(preds, obj_t, box_t, cls_t, masks, num_classes,
               reduction="mean"):
    """The v3 loss: BCE(obj) over non-ignored priors (see
    :func:`yolo3_targets`' ignore band) + (BCE(cls) + L2 on
    (σ(txy), twh)) on positives.  ``reduction='mean'`` averages over the
    batch (a scalar); ``'none'`` returns the per-sample loss ``[B]`` (the
    form SPMDTrainer loss_fns return)."""
    from ... import ndarray as nd

    pos_mask = nd.slice_axis(masks, axis=-1, begin=0, end=1)
    obj_w = nd.slice_axis(masks, axis=-1, begin=1, end=2)

    txy = nd.sigmoid(nd.slice_axis(preds, axis=-1, begin=0, end=2))
    twh = nd.slice_axis(preds, axis=-1, begin=2, end=4)
    obj = nd.slice_axis(preds, axis=-1, begin=4, end=5)
    cls = nd.slice_axis(preds, axis=-1, begin=5, end=5 + num_classes)

    def bce(logit, target):
        return nd.relu(logit) - logit * target + nd.log1p(nd.exp(-nd.abs(logit)))

    box_pred = nd.concat(txy, twh, dim=-1)
    per_sample = (nd.sum(bce(obj, obj_t) * obj_w, axis=(1, 2))
                  + nd.sum(bce(cls, cls_t) * pos_mask, axis=(1, 2))
                  + nd.sum(nd.square(box_pred - box_t) * pos_mask,
                           axis=(1, 2)))
    if reduction == "none":
        return per_sample
    return nd.mean(per_sample)


def yolo3_darknet53(num_classes=80, **kwargs):
    """YOLOv3 with the Darknet-53 backbone (the canonical config)."""
    return YOLOV3(DarknetV3(), num_classes=num_classes, **kwargs)
