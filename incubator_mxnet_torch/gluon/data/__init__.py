"""``gluon.data``: datasets, samplers, the DataLoader and ``vision``
(counterpart of the JAX package's ``gluon/data/``)."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler, FilterSampler
from .dataloader import DataLoader
from . import vision

__all__ = [
    "Dataset",
    "ArrayDataset",
    "SimpleDataset",
    "RecordFileDataset",
    "Sampler",
    "SequentialSampler",
    "RandomSampler",
    "FilterSampler",
    "BatchSampler",
    "DataLoader",
    "vision",
]
