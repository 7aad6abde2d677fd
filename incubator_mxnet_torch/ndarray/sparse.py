"""``mx.nd.sparse``: the ``row_sparse`` and ``csr`` storage types.

Counterpart of the JAX package's ``ndarray/sparse.py``: a sparse array is
its index and value tensors (NDArrays) and a dense shape.  ``row_sparse``
holds K rows of an [N, ...] array (the gradient format of
``Embedding(sparse_grad=True)``), ``csr`` (data, indices, indptr) a
matrix's non-zeros row by row (the input format of the linear examples).
``dot`` keeps csr structured: ``csr · dense`` gathers the dense rows of
the column ids and adds each product into its row (``index_add``),
``csrᵀ · dense`` gathers by row id and adds into the column ids; every
other product densifies first.  ``add`` of two row_sparse arrays merges
their rows, ``retain`` keeps the requested rows, ``cast_storage`` and
``tostype`` convert.  A constructor puts its result on ``ctx``'s device,
else on its source tensor's, else on the current context's, and finds a
dense source's non-zeros there.  On the card ``index_add`` adds by atomics unless
PyTorch's deterministic mode gives it its sorted path, so a product's sums
may come in another order than the CPU's.

The optimizer side of row_sparse is in ``optimizer/optimizer.py``: a
parameter with ``stype='row_sparse'`` (``Parameter(stype=)``,
``Embedding(sparse_grad=True)``) keeps a dense gradient and takes the lazy
updates of ``ops/optimizer_ops.py``, which leave every row the gradient
does not touch, and its optimizer state, as they were.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import as_torch_dtype
from ..context import current_context
from .ndarray import NDArray, _wrap

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray", "row_sparse_array",
           "csr_matrix", "zeros", "array", "empty", "dot", "add", "retain", "cast_storage"]


def _device(ctx):
    return (ctx if ctx is not None else current_context()).device


def _nd(x, dtype=None, device=None):
    """An NDArray of ``x`` (NDArray, tensor or array-like)."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        arr = _np.asarray(x)
        if dtype is None and arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        t = torch.from_numpy(_np.array(arr, copy=True))
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))
    return _wrap(t.to(device) if device is not None else t)


def _idx(x, device=None):
    return _nd(x, "int32", device)


class BaseSparseNDArray:
    stype = "undefined"

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype):
        raise NotImplementedError

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        if stype == "row_sparse":
            return row_sparse_array(self.todense())
        if stype == "csr":
            return csr_matrix(self.todense())
        raise ValueError(f"cannot convert {self.stype} to {stype}")

    def wait_to_read(self):
        self.data.wait_to_read()

    def __repr__(self):
        return f"<{type(self).__name__} {self.shape} @{self.stype}>"


class RowSparseNDArray(BaseSparseNDArray):
    """(indices [K], values [K, ...]): K stored rows of an [N, ...] array."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape):
        self.data = _nd(data)
        self.indices = _idx(indices, self.data._data.device)
        self._shape = tuple(shape)
        assert self.data.shape[0] == self.indices.shape[0]
        assert self.data.shape[1:] == self._shape[1:]

    def todense(self):
        v = self.data._data
        out = v.new_zeros(self._shape)
        return _wrap(out.index_add(0, self.indices._data.to(torch.long), v))

    def astype(self, dtype):
        return RowSparseNDArray(self.data.astype(dtype), self.indices, self._shape)

    def copy(self):
        return RowSparseNDArray(_wrap(self.data._data.clone()),
                                _wrap(self.indices._data.clone()), self._shape)

    def retain(self, rows):
        return retain(self, rows)

    def __add__(self, other):
        return add(self, other)


class CSRNDArray(BaseSparseNDArray):
    """(data [nnz], indices [nnz], indptr [N+1]): compressed sparse rows."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self.data = _nd(data)
        dev = self.data._data.device
        self.indices = _idx(indices, dev)
        self.indptr = _idx(indptr, dev)
        self._shape = tuple(shape)
        assert self.indptr.shape[0] == self._shape[0] + 1

    def _rows(self):
        return _csr_rows(self.indptr._data, self.data.shape[0])

    def todense(self):
        n, m = self._shape
        v = self.data._data
        out = v.new_zeros((n * m,))
        flat = self._rows() * m + self.indices._data.to(torch.long)
        return _wrap(out.index_add(0, flat, v).reshape(n, m))

    def astype(self, dtype):
        return CSRNDArray(self.data.astype(dtype), self.indices, self.indptr, self._shape)

    def copy(self):
        return CSRNDArray(_wrap(self.data._data.clone()), _wrap(self.indices._data.clone()),
                          _wrap(self.indptr._data.clone()), self._shape)

    def __getitem__(self, i):
        lo, hi = int(self.indptr._data[i]), int(self.indptr._data[i + 1])
        v = self.data._data
        row = v.new_zeros((self._shape[1],))
        row[self.indices._data[lo:hi].to(torch.long)] = v[lo:hi]
        return _wrap(row)


def _csr_rows(indptr, nnz):
    """The row id of each stored non-zero."""
    return torch.searchsorted(indptr.to(torch.long),
                              torch.arange(nnz, device=indptr.device), right=True) - 1


# -- constructors -------------------------------------------------------------------------


def _target(arg, ctx):
    """A constructor's device: ``ctx``'s, else the source tensor's, else the
    current context's (the card unless the caller asks for the CPU)."""
    if ctx is not None:
        return ctx.device
    for x in (arg if isinstance(arg, tuple) else (arg,)):
        t = x._data if isinstance(x, NDArray) else x
        if isinstance(t, torch.Tensor):
            return t.device
    return current_context().device


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """From ``(data, indices)`` and ``shape``, or from a dense source (its
    rows with a non-zero element), on ``_target``'s device."""
    dev = _target(arg1, ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(_nd(data, dtype, dev), indices, shape)
    dense = _nd(arg1, None, dev)._data
    nz_rows = torch.nonzero(dense.reshape(dense.shape[0], -1).ne(0).any(1)).reshape(-1)
    return RowSparseNDArray(_nd(dense[nz_rows], dtype), nz_rows, dense.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """From ``(data, indices, indptr)`` and ``shape``, or from a dense 2-D
    source, on ``_target``'s device."""
    dev = _target(arg1, ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(_nd(data, dtype, dev), indices, indptr, shape)
    dense = _nd(arg1, None, dev)._data
    assert dense.dim() == 2
    rows, cols = torch.nonzero(dense, as_tuple=True)  # row-major, as numpy's
    indptr = torch.searchsorted(rows, torch.arange(dense.shape[0] + 1, device=dev))
    return CSRNDArray(_nd(dense[rows, cols], dtype), cols, indptr, dense.shape)


def zeros(stype, shape, ctx=None, dtype=None):
    dt = as_torch_dtype(dtype or "float32")
    dev = _device(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
                                torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32, device=dev), shape)
    from .ndarray import zeros as dense_zeros
    return dense_zeros(shape, ctx=ctx, dtype=dtype or "float32")


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx, dtype)


def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, (RowSparseNDArray, CSRNDArray)):
        return source_array.copy()
    raise ValueError("use row_sparse_array/csr_matrix for dense sources")


# -- ops ------------------------------------------------------------------------------------


def _dense(x):
    return x.todense() if isinstance(x, BaseSparseNDArray) else x


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """sparse · dense: csr · dense and csrᵀ · dense stay structured (a
    gather, then ``index_add`` into the output rows); everything else
    densifies, then multiplies."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        rows = lhs._rows()
        cols = lhs.indices._data.to(torch.long)
        vals = lhs.data._data
        r = rhs._data.t() if transpose_b else rhs._data
        if not transpose_a:
            contrib = vals[:, None] * r[cols]
            out = contrib.new_zeros((lhs.shape[0], r.shape[1]))
            return _wrap(out.index_add(0, rows, contrib))
        contrib = vals[:, None] * r[rows]
        out = contrib.new_zeros((lhs.shape[1], r.shape[1]))
        return _wrap(out.index_add(0, cols, contrib))
    a, b = _dense(lhs)._data, _dense(rhs)._data
    return _wrap(torch.matmul(a.t() if transpose_a else a, b.t() if transpose_b else b))


def add(lhs, rhs):
    """row_sparse + row_sparse → row_sparse with the union of the rows;
    anything else densifies."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        idx = torch.cat([lhs.indices._data, rhs.indices._data]).to(torch.long)
        val = torch.cat([lhs.data._data, rhs.data._data])
        uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
        summed = val.new_zeros((uniq.shape[0],) + tuple(val.shape[1:])).index_add(0, inv, val)
        return RowSparseNDArray(_wrap(summed), uniq, lhs.shape)
    return _wrap(_dense(lhs)._data + _dense(rhs)._data)


def retain(data, indices):
    """The stored rows of a row_sparse array that ``indices`` asks for."""
    assert isinstance(data, RowSparseNDArray)
    stored = data.indices._data
    want = indices._data if isinstance(indices, NDArray) else indices
    want = torch.as_tensor(want, device=stored.device).to(stored.dtype)
    keep = torch.nonzero(torch.isin(stored, want)).reshape(-1)
    return RowSparseNDArray(_wrap(data.data._data[keep]), stored[keep], data.shape)


def cast_storage(arr, stype):
    """Convert between ``'default'``, ``'row_sparse'`` and ``'csr'``; a cast
    to the array's own type returns it."""
    if stype not in ("default", "row_sparse", "csr"):
        raise ValueError(f"unknown storage type {stype!r}")
    if getattr(arr, "stype", "default") == stype:
        return arr
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "row_sparse":
        return row_sparse_array(arr)
    return csr_matrix(arr)
