"""``gluon.data.vision``: vision datasets and transforms (counterpart of
the JAX package's ``gluon/data/vision/``)."""
from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset, ImageFolderDataset, SyntheticImageDataset
from . import transforms

__all__ = [
    "MNIST",
    "FashionMNIST",
    "CIFAR10",
    "CIFAR100",
    "ImageRecordDataset",
    "ImageFolderDataset",
    "SyntheticImageDataset",
    "transforms",
]
