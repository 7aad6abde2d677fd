"""Vision datasets (counterpart of the JAX package's
``gluon/data/vision/datasets.py``; parity: MXNet's
``python/mxnet/gluon/data/vision/datasets.py``).

MNIST/CIFAR read the standard on-disk formats from a local root (nothing
is downloaded) and keep the JAX package's deterministic synthetic stand-in
when the files are absent; ``SyntheticImageDataset`` provides the
``--benchmark 1`` synthetic-data mode the reference builds into its
trainers as a first-class dataset.  Images are NDArrays on the CPU.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as _np

from ...data.dataset import Dataset
from ....io.io import host_array as array

__all__ = [
    "MNIST",
    "FashionMNIST",
    "CIFAR10",
    "CIFAR100",
    "ImageRecordDataset",
    "ImageFolderDataset",
    "SyntheticImageDataset",
]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx-ubyte files (parity: ``vision.MNIST``).  Looks for the
    standard files under root; falls back to a deterministic synthetic set
    when absent (nothing is downloaded) so examples and tests stay runnable."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
        magic, = struct.unpack(">i", data[:4])
        ndim = magic % 256
        dims = struct.unpack(">" + "i" * ndim, data[4 : 4 + 4 * ndim])
        return _np.frombuffer(data, dtype=_np.uint8, offset=4 + 4 * ndim).reshape(dims)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        paths = [os.path.join(self._root, f) for f in files]
        alt = [p[:-3] for p in paths]  # uncompressed variants
        if all(os.path.exists(p) for p in paths) or all(os.path.exists(p) for p in alt):
            use = paths if os.path.exists(paths[0]) else alt
            images = self._read_idx(use[0])
            labels = self._read_idx(use[1])
            self._data = array(images.reshape(-1, *self._shape))
            self._label = labels.astype("int32")
        else:
            n = 6000 if self._train else 1000
            rng = _np.random.RandomState(42 if self._train else 43)
            labels = rng.randint(0, self._classes, size=n).astype("int32")
            images = _np.zeros((n,) + self._shape, dtype="uint8")
            # class-dependent pattern so models can actually learn
            for i, lab in enumerate(labels):
                img = rng.uniform(0, 48, self._shape).astype("uint8")
                r, c = divmod(int(lab), 4)
                img[4 + r * 6 : 10 + r * 6, 4 + c * 6 : 10 + c * 6, :] = 220
                images[i] = img
            self._data = array(images)
            self._label = labels

    def __getitem__(self, idx):
        img = self._data[idx]
        lab = self._label[idx]
        if self._transform is not None:
            return self._transform(img, lab)
        return img, lab


class FashionMNIST(MNIST):
    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from python-pickle batches; synthetic fallback offline."""

    _classes = 10
    _shape = (32, 32, 3)

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        batch_dir = os.path.join(self._root, "cifar-10-batches-py")
        files = (
            [f"data_batch_{i}" for i in range(1, 6)] if self._train else ["test_batch"]
        )
        paths = [os.path.join(batch_dir, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            xs, ys = [], []
            for p in paths:
                with open(p, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(_np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                ys.append(_np.asarray(d[b"labels"] if b"labels" in d else d[b"fine_labels"]))
            self._data = array(_np.concatenate(xs).astype("uint8"))
            self._label = _np.concatenate(ys).astype("int32")
        else:
            n = 5000 if self._train else 1000
            rng = _np.random.RandomState(7 if self._train else 8)
            labels = rng.randint(0, self._classes, size=n).astype("int32")
            images = rng.randint(0, 64, (n,) + self._shape).astype("uint8")
            for i, lab in enumerate(labels):
                images[i, :, :, lab % 3] = images[i, :, :, lab % 3] // 2 + 16 * (lab + 1)
            self._data = array(images)
            self._label = labels

    def __getitem__(self, idx):
        img = self._data[idx]
        lab = self._label[idx]
        if self._transform is not None:
            return self._transform(img, lab)
        return img, lab


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=True, train=True, transform=None):
        super().__init__(root, train, transform)


class ImageRecordDataset(Dataset):
    """ImageRecord pack (parity: ``vision.ImageRecordDataset``) — reads
    im2rec-format RecordIO via recordio.py and decodes with image.imdecode."""

    def __init__(self, filename, flag=1, transform=None):
        from ...data.dataset import RecordFileDataset

        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import recordio, image

        raw = self._record[idx]
        header, img_bytes = recordio.unpack(raw)
        img = image.imdecode(img_bytes, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """Folder-of-class-folders dataset (parity:
    ``vision.ImageFolderDataset``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image

        fname, label = self.items[idx]
        with open(fname, "rb") as f:
            img = image.imdecode(f.read(), flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class SyntheticImageDataset(Dataset):
    """Deterministic random images+labels made in host memory from a seed:
    the ``--benchmark 1`` mode as a dataset."""

    def __init__(self, num_samples=1280, shape=(224, 224, 3), classes=1000, seed=0, dtype="uint8"):
        self._n = num_samples
        rng = _np.random.RandomState(seed)
        self._data = rng.randint(0, 255, (num_samples,) + tuple(shape)).astype(dtype)
        self._label = rng.randint(0, classes, (num_samples,)).astype("int32")

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        return array(self._data[idx]), self._label[idx]
