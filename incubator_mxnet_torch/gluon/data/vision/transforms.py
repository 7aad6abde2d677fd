"""Vision transforms (counterpart of the JAX package's
``gluon/data/vision/transforms.py``; parity: MXNet's
``python/mxnet/gluon/data/vision/transforms.py``).

Blocks of the port: an NDArray in gives an NDArray out (the currency rule),
a tensor or a numpy array gives a tensor.  They are host work, run by the
DataLoader's workers on the CPU.  The random ones draw from numpy's global
generator exactly as the JAX package's do, so one ``np.random.seed``
reproduces both; ``Resize`` and ``RandomResizedCrop`` resample as the JAX
package's linear image resize does (a triangle filter, widened when
shrinking: PyTorch's bilinear with ``antialias=True``), then round.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as _F

from ....base import as_torch_dtype
from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential

__all__ = [
    "Compose",
    "Cast",
    "ToTensor",
    "Normalize",
    "Resize",
    "CenterCrop",
    "RandomResizedCrop",
    "RandomCrop",
    "RandomFlipLeftRight",
    "RandomFlipTopBottom",
    "RandomBrightness",
    "RandomContrast",
    "RandomSaturation",
    "RandomHue",
    "RandomColorJitter",
    "RandomLighting",
]


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(_np.ascontiguousarray(x))


def _to_np(img):
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else _np.asarray(img)


def _out(arr):
    return torch.from_numpy(_np.ascontiguousarray(arr))


class Compose(Sequential):
    """Parity: ``transforms.Compose``."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)

    def forward(self, x, *args):
        for child in self._modules.values():
            x = child(x)
        return x


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return _tensor(x).to(as_torch_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (parity: ``ToTensor``)."""

    def hybrid_forward(self, F, x):
        x = _tensor(x).to(torch.float32)
        perm = (2, 0, 1) if x.ndim == 3 else (0, 3, 1, 2)
        return x.permute(*perm).contiguous() / 255.0


class Normalize(HybridBlock):
    """Channel-wise normalize of CHW tensors (parity: ``Normalize``)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype="float32")
        self._std = _np.asarray(std, dtype="float32")

    def hybrid_forward(self, F, x):
        x = _tensor(x)
        c = x.shape[0] if x.ndim == 3 else x.shape[1]
        shape = (c, 1, 1) if x.ndim == 3 else (1, c, 1, 1)
        mean = torch.from_numpy(_np.broadcast_to(self._mean, (c,)).reshape(shape).copy())
        std = torch.from_numpy(_np.broadcast_to(self._std, (c,)).reshape(shape).copy())
        return (x - mean.to(x.device)) / std.to(x.device)


def _resize_linear(img, h, w):
    """The JAX package's linear resize of an HWC image, rounded and clipped
    to [0, 255] in the input's dtype."""
    x = _tensor(img)
    src = x.to(torch.float32).permute(2, 0, 1)[None]
    out = _F.interpolate(src, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)[0].permute(1, 2, 0)
    return torch.clamp(torch.round(out), 0, 255).to(x.dtype).contiguous()


class Resize(Block):
    """Parity: ``transforms.Resize`` (HWC input)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        return _resize_linear(x, self._size[1], self._size[0])


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        img = _to_np(x)
        w, h = self._size
        H, W = img.shape[0], img.shape[1]
        y0 = max(0, (H - h) // 2)
        x0 = max(0, (W - w) // 2)
        return _out(img[y0 : y0 + h, x0 : x0 + w])


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        img = _to_np(x)
        if self._pad:
            img = _np.pad(img, ((self._pad, self._pad), (self._pad, self._pad), (0, 0)), mode="constant")
        w, h = self._size
        H, W = img.shape[0], img.shape[1]
        y0 = _np.random.randint(0, max(1, H - h + 1))
        x0 = _np.random.randint(0, max(1, W - w + 1))
        return _out(img[y0 : y0 + h, x0 : x0 + w])


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        img = _to_np(x)
        H, W = img.shape[0], img.shape[1]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = _np.random.randint(0, W - w + 1)
                y0 = _np.random.randint(0, H - h + 1)
                crop = img[y0 : y0 + h, x0 : x0 + w]
                break
        else:
            crop = img
        return _resize_linear(crop, self._size[1], self._size[0])


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _np.random.rand() < self._p:
            return _out(_to_np(x)[:, ::-1])
        return _tensor(x)


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _np.random.rand() < self._p:
            return _out(_to_np(x)[::-1])
        return _tensor(x)


class _RandomJitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + _np.random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype("float32") * self._factor()
        return _out(_np.clip(img, 0, 255).astype(_to_np(x).dtype))


class RandomContrast(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype("float32")
        mean = img.mean()
        out = (img - mean) * self._factor() + mean
        return _out(_np.clip(out, 0, 255).astype(_to_np(x).dtype))


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype("float32")
        gray = img.mean(axis=-1, keepdims=True)
        out = (img - gray) * self._factor() + gray
        return _out(_np.clip(out, 0, 255).astype(_to_np(x).dtype))


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (parity: ``RandomLighting``)."""

    _eigval = _np.asarray([55.46, 4.794, 1.148], dtype="float32")
    _eigvec = _np.asarray(
        [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814], [-0.5836, -0.6948, 0.4203]],
        dtype="float32",
    )

    def __init__(self, alpha=0.1):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = _to_np(x).astype("float32")
        a = _np.random.normal(0, self._alpha, 3).astype("float32")
        noise = (self._eigvec * a * self._eigval).sum(axis=1)
        out = img + noise
        return _out(_np.clip(out, 0, 255).astype(_to_np(x).dtype))


class RandomHue(_RandomJitter):
    """YIQ-rotation hue jitter (parity: ``transforms.RandomHue``); the
    rotation matrix comes from ``image.HueJitterAug.hue_matrix``."""

    def forward(self, x):
        from ....image.image import HueJitterAug

        src = _to_np(x)
        alpha = _np.random.uniform(-self._amount, self._amount)
        t = HueJitterAug.hue_matrix(alpha)
        out = src.astype("float32") @ t.T
        if _np.issubdtype(src.dtype, _np.integer):
            out = _np.rint(out)
        return _out(_np.clip(out, 0, 255).astype(src.dtype))


class RandomColorJitter(Block):
    """Random-order brightness/contrast/saturation/hue jitter (parity:
    ``transforms.RandomColorJitter``)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        # numpy's global RNG orders AND draws every jitter, so one
        # np.random.seed reproduces the whole augmentation
        order = [self._ts[i] for i in _np.random.permutation(len(self._ts))]
        for t in order:
            x = t(x)
        return x
