"""``mx.nd.save`` and ``mx.nd.load``.

Counterpart of the JAX package's ``ndarray/utils.py``, file for file: what
either package writes, the other loads to the same names and values.  Two
containers:

* ``.params`` (and ``format='params'``): the reference's binary layout,
  little-endian: uint64 list magic 0x112 and a reserved word, the count,
  one record per array (V2 magic, storage type, uint32 ndim, int64 dims,
  the cpu(0) context, the mshadow type flag, the raw data), then the name
  table.  bfloat16 has no type flag there and is written as float32 (the
  values are exact).  V1, V2 and V3 records load; sparse ones do not.
* anything else: numpy ``.npz``, keys ``idx:<n>`` for a list.  A bfloat16
  array is written as the JAX package writes it, its 2-byte bit patterns
  under the descriptor ``'<V2'``, so the file is byte-for-byte the same;
  a 2-byte void record loads as bfloat16.  (The JAX package's own ``load``
  cannot read such a record; the port can.)

``load`` sniffs the container by its magic.
"""
from __future__ import annotations

import struct
import zipfile

import numpy as _np
import torch

__all__ = ["save", "load"]

_LIST_MAGIC = 0x112            # kMXAPINDArrayListMagic
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V3_MAGIC = 0xF993FACA

# mshadow type flags
_TYPE_FLAG_TO_DTYPE = {
    0: _np.dtype("float32"), 1: _np.dtype("float64"), 2: _np.dtype("float16"),
    3: _np.dtype("uint8"), 4: _np.dtype("int32"), 5: _np.dtype("int8"),
    6: _np.dtype("int64"),
}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}
_BF16_DESCR = "<V2"  # how numpy names ml_dtypes' bfloat16 in an .npy header


def _tensor(v):
    from .ndarray import NDArray

    t = v._data if isinstance(v, NDArray) else v
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"cannot save {type(v)}")
    return t.detach()


def _host(t):
    """A host copy: a numpy array, or for bf16 the raw 2-byte patterns as
    uint16."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(_np.uint16), True
    return t.cpu().numpy(), False


def _write_params(f, payload):
    """payload: list of (name or None, tensor)."""
    f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
    f.write(struct.pack("<Q", len(payload)))
    for _, t in payload:
        arr = (t.float() if t.dtype == torch.bfloat16 else t).contiguous().cpu().numpy()
        if arr.dtype not in _DTYPE_TO_TYPE_FLAG:
            arr = arr.astype(_np.float32)
        f.write(struct.pack("<I", _NDARRAY_V2_MAGIC))
        f.write(struct.pack("<i", 0))                      # stype: kDefaultStorage
        f.write(struct.pack("<I", arr.ndim))
        for d in arr.shape:
            f.write(struct.pack("<q", d))
        f.write(struct.pack("<ii", 1, 0))                  # Context: cpu(0)
        f.write(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[arr.dtype]))
        f.write(arr.tobytes())
    names = [n for n, _ in payload if n is not None]
    f.write(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)


def _write_npz(f, payload):
    """numpy's ``savez`` layout (stored zip, zip64 members), with bfloat16
    members headed ``'<V2'`` as numpy writes ml_dtypes' bfloat16."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, t in payload:
            arr, bf16 = _host(t)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if bf16:
                    _np.lib.format.write_array_header_1_0(
                        fid, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
                    fid.write(arr.tobytes())
                else:
                    _np.lib.format.write_array(fid, arr, allow_pickle=False)


def _read_ndarray_record(f):
    magic = struct.unpack("<I", f.read(4))[0]
    if magic == _NDARRAY_V1_MAGIC:
        stype = 0
    elif magic in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
        stype = struct.unpack("<i", f.read(4))[0]
    else:
        raise ValueError(f"unsupported NDArray record magic 0x{magic:x}")
    if stype not in (0, -1):  # kDefaultStorage / kUndefinedStorage
        raise NotImplementedError(
            f"sparse storage type {stype} in .params is not supported (dense only)")
    ndim = struct.unpack("<I", f.read(4))[0]
    shape = tuple(struct.unpack("<q", f.read(8))[0] for _ in range(ndim))
    struct.unpack("<ii", f.read(8))  # the saved context; arrays load where asked
    type_flag = struct.unpack("<i", f.read(4))[0]
    dtype = _TYPE_FLAG_TO_DTYPE.get(type_flag)
    if dtype is None:
        raise ValueError(f"unknown type flag {type_flag} in .params")
    count = 1
    for d in shape:
        count *= d
    return _np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype).reshape(shape)


def _read_params(f):
    magic, _reserved = struct.unpack("<QQ", f.read(16))
    if magic != _LIST_MAGIC:
        raise ValueError(f"bad .params magic 0x{magic:x}")
    n = struct.unpack("<Q", f.read(8))[0]
    arrays = [_read_ndarray_record(f) for _ in range(n)]
    raw = f.read(8)
    nkeys = struct.unpack("<Q", raw)[0] if len(raw) == 8 else 0
    names = []
    for _ in range(nkeys):
        ln = struct.unpack("<Q", f.read(8))[0]
        names.append(f.read(ln).decode("utf-8"))
    if names and len(names) != len(arrays):
        raise ValueError(f".params name table has {len(names)} keys for {len(arrays)} arrays")
    return names, arrays


def _from_record(arr):
    """A CPU tensor from a loaded numpy array (2-byte void records are
    bfloat16 bit patterns)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = _np.frombuffer(arr.tobytes(), dtype=_np.int16).reshape(arr.shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, where it is installed
        return torch.from_numpy(arr.astype(_np.float32)).to(torch.bfloat16)
    return torch.from_numpy(_np.array(arr, copy=True))


def _load_tensors(fname):
    """The file's arrays as CPU tensors: a dict by name, or a list."""
    with open(fname, "rb") as f:
        head = f.read(8)
    if len(head) == 8 and struct.unpack("<Q", head)[0] == _LIST_MAGIC:
        with open(fname, "rb") as f:
            names, arrays = _read_params(f)
        tensors = [_from_record(a) for a in arrays]
        return dict(zip(names, tensors)) if names else tensors
    with _np.load(fname, allow_pickle=False) as z:
        keys = list(z.keys())
        if keys and all(k.startswith("idx:") for k in keys):
            keys.sort(key=lambda k: int(k.split(":", 1)[1]))
            return [_from_record(z[k]) for k in keys]
        return {k: _from_record(z[k]) for k in keys}


def save(fname, data, format=None):
    """Save an NDArray, a list of them or a str-keyed dict of them (tensors
    too).  ``.params`` paths (or ``format='params'``) use the reference
    binary layout; everything else npz."""
    if isinstance(data, dict):
        payload = [(k, _tensor(v)) for k, v in data.items()]
    else:
        if not isinstance(data, (list, tuple)):
            data = [data]
        payload = [(None, _tensor(v)) for v in data]
    if format == "params" or (format is None and str(fname).endswith(".params")):
        with open(fname, "wb") as f:
            _write_params(f, payload)
        return
    if payload and payload[0][0] is None:
        payload = [(f"idx:{i}", t) for i, (_, t) in enumerate(payload)]
    with open(fname, "wb") as f:
        _write_npz(f, payload)


def load(fname, ctx=None):
    """Load what ``save`` (of either package, or the reference's
    ``mx.nd.save``) wrote: a dict by name or a list of NDArrays, on ``ctx``
    (default: the current context)."""
    from ..context import current_context
    from .ndarray import _wrap

    ctx = ctx if ctx is not None else current_context()
    loaded = _load_tensors(fname)
    if isinstance(loaded, dict):
        return {k: _wrap(t.to(ctx.device), ctx) for k, t in loaded.items()}
    return [_wrap(t.to(ctx.device), ctx) for t in loaded]
