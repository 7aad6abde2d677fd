"""``mx.image``: image decode/augment utilities.

Counterpart of the JAX package's ``image/image.py`` (parity target:
MXNet's ``python/mxnet/image/image.py``: ``imdecode``, ``imresize``,
``fixed_crop``/``center_crop``/``random_crop``, ``color_normalize``, the
augmenter list, ``ImageIter``).  The reference backs these with C++ OpenCV
ops; here decode and resize use Pillow and the array math numpy, on the
host: images are NDArrays on the CPU.  The high-throughput training path
is ``mx.io.ImageRecordIter`` (the native decode pool); this module is the
flexible per-image API.
"""
from __future__ import annotations

import io as _pyio
import os
import random as _pyrandom

import numpy as _np

import torch

from ..ndarray.ndarray import NDArray, _wrap
from ..io.io import DataBatch, DataDesc, DataIter, host_array
from ..base import as_torch_dtype


class _HostND:
    """``nd.array`` on the CPU context: every image of this module lives in
    host memory."""

    @staticmethod
    def array(source, dtype=None):
        arr = _np.asarray(source, dtype=dtype) if dtype is not None else _np.asarray(source)
        return host_array(arr)


nd = _HostND

__all__ = [
    "imdecode", "imread", "imresize", "resize_short", "fixed_crop",
    "center_crop", "random_crop", "color_normalize", "HorizontalFlipAug",
    "CastAug", "ColorNormalizeAug", "ResizeAug", "ForceResizeAug",
    "RandomCropAug", "CenterCropAug", "RandomSizedCropAug",
    "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
    "HueJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
    "SequentialAug", "RandomOrderAug", "CreateAugmenter", "ImageIter",
]


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode encoded image bytes → HWC uint8 NDArray (parity:
    ``mx.image.imdecode``; OpenCV's BGR default is normalized to RGB when
    ``to_rgb``, matching the reference flag semantics)."""
    from PIL import Image

    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(_pyio.BytesIO(bytes(buf)))
    img = img.convert("RGB" if flag else "L")
    arr = _np.asarray(img)
    if flag and not to_rgb:
        arr = arr[..., ::-1].copy()  # caller wants BGR
    if not flag:
        arr = arr[..., None]
    res = nd.array(arr, dtype="uint8")
    if out is not None:
        out._data = res._data
        out._version += 1
        return out
    return res


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize HWC image to (h, w) (parity: ``mx.image.imresize``)."""
    from PIL import Image

    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    method = Image.NEAREST if interp == 0 else Image.BILINEAR
    if arr.dtype == _np.uint8:
        squeeze = arr.ndim == 3 and arr.shape[2] == 1
        img = Image.fromarray(arr[..., 0] if squeeze else arr)
        out = _np.asarray(img.resize((w, h), method))
        if squeeze:
            out = out[..., None]
    else:
        # float images (mid-pipeline augs): PIL only takes mode-'F'
        # single-channel floats — resize per channel and restack
        f = arr.astype(_np.float32)
        if f.ndim == 2:
            f = f[..., None]
        chans = [_np.asarray(Image.fromarray(f[..., c], mode="F")
                             .resize((w, h), method))
                 for c in range(f.shape[2])]
        out = _np.stack(chans, axis=2)
        if _np.issubdtype(arr.dtype, _np.integer):
            out = _np.rint(out)
        out = out.astype(arr.dtype)
        if arr.ndim == 2:
            out = out[..., 0]
    return nd.array(out, dtype=str(arr.dtype))


def resize_short(src, size, interp=1):
    """Resize shorter side to ``size`` keeping aspect ratio."""
    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    h, w = arr.shape[:2]
    if h > w:
        new_h, new_w = int(size * h / w), size
    else:
        new_h, new_w = size, int(size * w / h)
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    res = nd.array(out, dtype=str(arr.dtype))
    if size is not None and (w, h) != size:
        res = imresize(res, size[0], size[1], interp)
    return res


def center_crop(src, size, interp=1):
    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    h, w = arr.shape[:2]
    cw, ch = size
    x0 = max((w - cw) // 2, 0)
    y0 = max((h - ch) // 2, 0)
    out = fixed_crop(src, x0, y0, min(cw, w), min(ch, h), size, interp)
    return out, (x0, y0, cw, ch)


def random_crop(src, size, interp=1):
    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    h, w = arr.shape[:2]
    cw, ch = size
    x0 = _pyrandom.randint(0, max(w - cw, 0))
    y0 = _pyrandom.randint(0, max(h - ch, 0))
    out = fixed_crop(src, x0, y0, min(cw, w), min(ch, h), size, interp)
    return out, (x0, y0, cw, ch)


def color_normalize(src, mean, std=None):
    src = src if isinstance(src, NDArray) else nd.array(src)
    src = _wrap(src._data.to(torch.float32))
    out = src - (mean if isinstance(mean, NDArray) else nd.array(_np.asarray(mean, dtype=_np.float32)))
    if std is not None:
        out = out / (std if isinstance(std, NDArray) else nd.array(_np.asarray(std, dtype=_np.float32)))
    return out


# -- augmenters (parity: Augmenter classes) ---------------------------------

class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
            return nd.array(arr[:, ::-1].copy(), dtype=str(arr.dtype))
        return src


class CastAug(Augmenter):
    def __init__(self, dtype="float32"):
        self.dtype = dtype

    def __call__(self, src):
        return _wrap(src._data.to(as_torch_dtype(self.dtype)))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean = _np.asarray(mean, dtype=_np.float32)
        self.std = _np.asarray(std, dtype=_np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, nd.array(self.mean),
                               nd.array(self.std) if self.std is not None else None)


def _as_float_np(src):
    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    return arr.astype(_np.float32, copy=True)


_GRAY_COEF = _np.array([0.299, 0.587, 0.114], dtype=_np.float32)  # RGB


class RandomSizedCropAug(Augmenter):
    """Random area+aspect crop then resize — the GoogLeNet/ImageNet
    training crop ([U:python/mxnet/image/image.py] random_size_crop)."""

    def __init__(self, size, area, ratio, interp=1):
        self.size = size
        self.area = (area, 1.0) if _np.isscalar(area) else tuple(area)
        self.ratio = tuple(ratio)
        self._log_ratio = (_np.log(self.ratio[0]), _np.log(self.ratio[1]))
        self.interp = interp

    def __call__(self, src):
        arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
        h, w = arr.shape[:2]
        src_area = h * w
        for _ in range(10):
            target_area = _pyrandom.uniform(*self.area) * src_area
            aspect = _np.exp(_pyrandom.uniform(*self._log_ratio))
            new_w = int(round((target_area * aspect) ** 0.5))
            new_h = int(round((target_area / aspect) ** 0.5))
            if new_w <= w and new_h <= h:
                x0 = _pyrandom.randint(0, w - new_w)
                y0 = _pyrandom.randint(0, h - new_h)
                return fixed_crop(arr, x0, y0, new_w, new_h,
                                  self.size, self.interp)
        # fallback: center crop to the largest fitting square, then resize
        s = min(h, w)
        return fixed_crop(arr, (w - s) // 2, (h - s) // 2, s, s,
                          self.size, self.interp)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return nd.array(_as_float_np(src) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = _as_float_np(src)
        gray_mean = (arr * _GRAY_COEF).sum(axis=2).mean()
        return nd.array(arr * alpha + gray_mean * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = _as_float_np(src)
        gray = (arr * _GRAY_COEF).sum(axis=2, keepdims=True)
        return nd.array(arr * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """YIQ-rotation hue jitter (the reference's tyiq/ityiq formulation)."""

    _TYIQ = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], dtype=_np.float32)
    # exact inverse (the reference hard-codes a 3-decimal truncation,
    # which makes hue=0 a visible non-identity; the inverse is the intent)
    _ITYIQ = _np.linalg.inv(_TYIQ.astype(_np.float64)).astype(_np.float32)

    def __init__(self, hue):
        self.hue = hue

    @classmethod
    def hue_matrix(cls, alpha):
        """RGB-space rotation for a hue shift of ``pi*alpha`` (shared with
        ``gluon.data.vision.transforms.RandomHue``)."""
        theta = _np.pi * alpha
        u, w = _np.cos(theta), _np.sin(theta)
        bt = _np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], dtype=_np.float32)
        return cls._ITYIQ @ bt @ cls._TYIQ

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        t = self.hue_matrix(alpha)
        arr = _as_float_np(src)
        return nd.array(arr @ t.T)


class ColorJitterAug(Augmenter):
    """Random-order brightness/contrast/saturation jitter."""

    def __init__(self, brightness=0, contrast=0, saturation=0):
        self._augs = []
        if brightness:
            self._augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self._augs.append(ContrastJitterAug(contrast))
        if saturation:
            self._augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        order = list(self._augs)
        _pyrandom.shuffle(order)
        for a in order:
            src = a(src)
        return src


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, dtype=_np.float32)
        self.eigvec = _np.asarray(eigvec, dtype=_np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,)).astype(_np.float32)
        rgb = self.eigvec @ (alpha * self.eigval)
        return nd.array(_as_float_np(src) + rgb)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = _as_float_np(src)
            gray = (arr * _GRAY_COEF).sum(axis=2, keepdims=True)
            return nd.array(_np.broadcast_to(gray, arr.shape).copy())
        return src


class SequentialAug(Augmenter):
    def __init__(self, ts):
        self.ts = list(ts)

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        self.ts = list(ts)

    def __call__(self, src):
        order = list(self.ts)
        _pyrandom.shuffle(order)
        for t in order:
            src = t(src)
        return src


# ImageNet PCA statistics (the reference's CreateAugmenter defaults)
_PCA_EIGVAL = _np.array([55.46, 4.794, 1.148], dtype=_np.float32)
_PCA_EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype=_np.float32)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    interp=1, inter_method=None, **kwargs):
    """Build the standard augmenter list with the reference's FULL kwarg
    surface (parity: ``CreateAugmenter`` [U:python/mxnet/image/image.py]):
    resize → sized/random/center crop → color jitter → hue → pca lighting
    → random gray → mirror → cast → normalize."""
    if inter_method is not None:
        interp = inter_method
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, interp))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize requires rand_crop=True "
                             "(the reference asserts the same)")
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3 / 4.0, 4 / 3.0),
                                          interp))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, interp))
    else:
        auglist.append(CenterCropAug(crop_size, interp))
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53], dtype=_np.float32)
    if std is True:
        std = _np.array([58.395, 57.12, 57.375], dtype=_np.float32)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Python-side image iterator over .lst/.rec inputs (parity:
    ``mx.image.ImageIter`` — the flexible pipeline; the C++ one is
    ``mx.io.ImageRecordIter``)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, label_width=1,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or imglist, "need a data source"
        self._shape = tuple(data_shape)
        self._data_name = data_name
        self._label_name = label_name
        self.auglist = aug_list if aug_list is not None else CreateAugmenter(
            data_shape, **kwargs)
        self._rec = None
        self._items = []
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self._items = list(self._rec.keys)
            else:
                self._rec = MXRecordIO(path_imgrec, "r")
                offsets = []
                pos = self._rec.tell()
                while self._rec.read() is not None:
                    offsets.append(pos)
                    pos = self._rec.tell()
                self._items = offsets
        else:
            if imglist is None:
                imglist = []
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        imglist.append((float(parts[1]), parts[-1]))
            self._items = [(lab, os.path.join(path_root, p)) for lab, p in imglist]
        self._order = list(range(len(self._items)))
        self._shuffle = shuffle
        self._cursor = 0
        if shuffle:
            _pyrandom.shuffle(self._order)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size,) + self._shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            _pyrandom.shuffle(self._order)

    def _read_one(self, i):
        from ..recordio import unpack
        item = self._items[self._order[i]]
        if self._rec is not None:
            if hasattr(self._rec, "read_idx"):
                payload = self._rec.read_idx(item)
            else:
                self._rec.fh.seek(item)
                payload = self._rec.read()
            header, img_bytes = unpack(payload)
            label = header.label
            img = imdecode(img_bytes)
        else:
            label, path = item
            img = imread(path)
        for aug in self.auglist:
            img = aug(img)
        lab = label if _np.isscalar(label) else _np.asarray(label).ravel()[0]
        return img, float(lab)

    def next(self):
        c, h, w = self._shape
        remaining = len(self._order) - self._cursor
        if remaining <= 0:
            raise StopIteration
        n = min(self.batch_size, remaining)
        data = _np.zeros((self.batch_size, c, h, w), dtype=_np.float32)
        label = _np.zeros((self.batch_size,), dtype=_np.float32)
        for i in range(n):
            img, lab = self._read_one(self._cursor + i)
            arr = img.asnumpy() if isinstance(img, NDArray) else _np.asarray(img)
            data[i] = arr.transpose(2, 0, 1)
            label[i] = lab
        self._cursor += n
        pad = self.batch_size - n
        if pad:
            for i in range(n, self.batch_size):
                data[i] = data[i - n]
                label[i] = label[i - n]
        return DataBatch([nd.array(data)], [nd.array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
