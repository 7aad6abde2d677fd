"""Datasets (counterpart of the JAX package's ``gluon/data/dataset.py``;
parity: MXNet's ``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

import os

from ...ndarray.ndarray import NDArray, array

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self)) if fn(self[i])])

    def shard(self, num_shards, index):
        """Per-host sharding (parity: 1.7 ``Dataset.shard`` — the
        num_parts/part_index equivalent for data-parallel input)."""
        assert 0 <= index < num_shards
        idx = list(range(index, len(self), num_shards))
        base = self

        class _Shard(Dataset):
            def __len__(self):
                return len(idx)

            def __getitem__(self, i):
                return base[idx[i]]

        return _Shard()

    def take(self, count):
        base = self

        class _Take(Dataset):
            def __len__(self):
                return min(count, len(base))

            def __getitem__(self, i):
                if i >= len(self):
                    raise IndexError
                return base[i]

        return _Take()

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return _LazyTransformDataset(self, _First(fn), unpack=True)


class _First:
    """``fn`` on an item's first element (a class, not a closure, so that a
    transformed dataset pickles to the DataLoader's process workers)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *items):
        if len(items) == 1:
            return self._fn(items[0])
        return (self._fn(items[0]),) + items[1:]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn, unpack=False):
        self._data = data
        self._fn = fn
        self._unpack = unpack

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if self._unpack and isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of arrays (parity: ``data.ArrayDataset``)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for d in args:
            assert len(d) == self._length, "All arrays must have the same length"
            self._data.append(d)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file (parity: ``data.RecordFileDataset``;
    format-compatible with im2rec packs via recordio.py)."""

    def __init__(self, filename):
        from ... import recordio

        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])


NDArray, array  # re-export convenience
