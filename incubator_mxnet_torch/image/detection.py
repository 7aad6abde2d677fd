"""Detection image pipeline: augmenters that transform images AND their
box labels together, plus ``ImageDetIter``.

Counterpart of the JAX package's ``image/detection.py`` (parity:
[U:python/mxnet/image/detection.py], the SSD/YOLO data path:
``DetHorizontalFlipAug``/``DetRandomCropAug``/``CreateDetAugmenter`` and
``ImageDetIter``).  Labels follow the reference convention: one row per
object, ``[class_id, xmin, ymin, xmax, ymax]`` with coordinates
normalized to [0, 1]; padded rows carry class_id = -1.  Every batch is
padded to ``max_objects`` rows, so MultiBoxTarget sees static shapes.
The augmenters draw from numpy's global generator, as the JAX package's
do; images are decoded and augmented on the host, and each batch is a
pair of CPU NDArrays, as ``mx.io``'s are: the caller moves it to the card.
"""
from __future__ import annotations

import numpy as _np

from . import image as _img

__all__ = [
    "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
    "DetRandomCropAug", "CreateDetAugmenter", "ImageDetIter",
]


class DetAugmenter:
    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a plain image Augmenter (labels pass through unchanged —
    color/cast/normalize style augmenters)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if hasattr(src, "asnumpy"):
            src = src.asnumpy()
        if _np.random.rand() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x0 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x0
        return src, label


class DetRandomCropAug(DetAugmenter):
    """SSD-style IoU-constrained random crop: sample a crop whose IoU with
    at least one box exceeds ``min_object_covered``; boxes are clipped to
    the crop and dropped when their center falls outside."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), max_attempts=25):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _iou_1(self, crop, boxes):
        cx0, cy0, cx1, cy1 = crop
        ix0 = _np.maximum(boxes[:, 0], cx0)
        iy0 = _np.maximum(boxes[:, 1], cy0)
        ix1 = _np.minimum(boxes[:, 2], cx1)
        iy1 = _np.minimum(boxes[:, 3], cy1)
        inter = _np.clip(ix1 - ix0, 0, None) * _np.clip(iy1 - iy0, 0, None)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / _np.maximum(area, 1e-12)

    def __call__(self, src, label):
        if hasattr(src, "asnumpy"):
            src = src.asnumpy()
        h, w = src.shape[:2]
        valid = label[:, 0] >= 0
        boxes = label[valid, 1:5]
        if not valid.any():
            return src, label
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ar = _np.random.uniform(*self.aspect_ratio_range)
            cw = min(1.0, _np.sqrt(area * ar))
            ch = min(1.0, _np.sqrt(area / ar))
            cx = _np.random.uniform(0, 1 - cw)
            cy = _np.random.uniform(0, 1 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            covered = self._iou_1(crop, boxes)
            if covered.max() < self.min_object_covered:
                continue
            # keep boxes whose center lies inside the crop
            ctrx = (boxes[:, 0] + boxes[:, 2]) / 2
            ctry = (boxes[:, 1] + boxes[:, 3]) / 2
            keep = ((ctrx > crop[0]) & (ctrx < crop[2])
                    & (ctry > crop[1]) & (ctry < crop[3]))
            if not keep.any():
                continue
            x0, y0 = int(cx * w), int(cy * h)
            x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
            out = src[y0:y1, x0:x1]
            new_label = _np.full_like(label, -1.0)
            nb = boxes[keep].copy()
            nb[:, [0, 2]] = _np.clip((nb[:, [0, 2]] - crop[0]) / cw, 0, 1)
            nb[:, [1, 3]] = _np.clip((nb[:, [1, 3]] - crop[1]) / ch, 0, 1)
            cls = label[valid, 0][keep]
            new_label[: len(nb), 0] = cls
            new_label[: len(nb), 1:5] = nb
            return out, new_label
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, min_object_covered=0.3,
                       area_range=(0.3, 1.0)):
    """Standard det augmenter chain (parity: ``CreateDetAugmenter``)."""
    augs = []
    if resize > 0:
        # resize-short stage before cropping (upstream parity); boxes are
        # normalized so only the pixels change
        augs.append(DetBorrowAug(_img.ResizeAug(resize)))
    if rand_crop > 0:
        augs.append(DetRandomCropAug(min_object_covered=min_object_covered,
                                     area_range=area_range))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    augs.append(DetBorrowAug(_img.ForceResizeAug((data_shape[2], data_shape[1]))))
    augs.append(DetBorrowAug(_img.CastAug()))
    if mean is not None or std is not None:
        augs.append(DetBorrowAug(_img.ColorNormalizeAug(
            mean if mean is not None else _np.zeros(3, _np.float32),
            std if std is not None else _np.ones(3, _np.float32))))
    return augs


class ImageDetIter:
    """Batch iterator over (image, boxes) samples with det augmentation.

    ``imglist``: list of (label_rows [N, 5] normalized, image HWC uint8
    numpy array) — the in-memory mode; RecordIO det packs stream through
    the same augmenters via ``recordio`` + ``pack_img`` on the caller
    side.  Emits DataBatch(data=[B, C, H, W], label=[B, max_objects, 5]).
    """

    def __init__(self, imglist, batch_size, data_shape, max_objects=8,
                 augmenters=None, shuffle=False, **aug_kwargs):
        self._samples = list(imglist)
        if batch_size > len(self._samples):
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{len(self._samples)} — the iterator would yield nothing")
        self._batch = batch_size
        self._shape = data_shape
        self._max_objects = max_objects
        self._shuffle = shuffle
        self._augs = (augmenters if augmenters is not None
                      else CreateDetAugmenter(data_shape, **aug_kwargs))
        self.reset()

    def reset(self):
        self._order = _np.arange(len(self._samples))
        if self._shuffle:
            _np.random.shuffle(self._order)
        self._cursor = 0

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        from ..io.io import DataBatch, host_array

        if self._cursor >= len(self._samples):
            raise StopIteration
        c, h, w = self._shape
        data = _np.zeros((self._batch, h, w, c), _np.float32)
        labels = _np.full((self._batch, self._max_objects, 5), -1.0, _np.float32)
        for i in range(self._batch):
            # pad the trailing partial batch by wrapping around to the
            # epoch's start (upstream ImageDetIter pads the final batch
            # rather than dropping it)
            j = (self._cursor + i) % len(self._samples)
            lab, img = self._samples[self._order[j]]
            lab = _np.asarray(lab, _np.float32).reshape(-1, 5)
            lab_pad = _np.full((self._max_objects, 5), -1.0, _np.float32)
            n = min(len(lab), self._max_objects)
            if n:
                lab_pad[:n] = lab[:n]
            out, lab_pad = self._apply(img, lab_pad)
            data[i] = out
            labels[i] = lab_pad
        self._cursor += self._batch
        return DataBatch(data=[host_array(data.transpose(0, 3, 1, 2))],
                         label=[host_array(labels)])

    def _apply(self, img, label):
        # keep the native (uint8) dtype until CastAug — PIL resize inside
        # ForceResizeAug needs integer images
        out = _np.asarray(img)
        for aug in self._augs:
            out, label = aug(out, label)
        if hasattr(out, "asnumpy"):
            out = out.asnumpy()
        return _np.asarray(out, _np.float32), label
