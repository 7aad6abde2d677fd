"""``mx.io``: data iterators and the device-resident input pipeline.

Counterpart of the JAX package's ``io/`` (parity: MXNet's
``python/mxnet/io/``): :mod:`.io` (the iterator contract, ``NDArrayIter``,
``ResizeIter``, ``PrefetchingIter``, ``CSVIter``), :mod:`.record_iter`
(``ImageRecordIter`` on the port's native decode pool) and
:mod:`.pipeline` (``DataPipeline``: threaded prep, pinned staging and a
copy stream of its own onto the card).
"""
from .io import (
    DataDesc,
    DataBatch,
    DataIter,
    NDArrayIter,
    ResizeIter,
    PrefetchingIter,
    CSVIter,
)
from .record_iter import ImageRecordIter
from .pipeline import DataPipeline

__all__ = [
    "DataDesc",
    "DataBatch",
    "DataIter",
    "NDArrayIter",
    "ResizeIter",
    "PrefetchingIter",
    "CSVIter",
    "ImageRecordIter",
    "DataPipeline",
]
