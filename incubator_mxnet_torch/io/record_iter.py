"""ImageRecordIter: the record-file image iterator.

Counterpart of the JAX package's ``io/record_iter.py`` (parity target:
MXNet's ``src/io/iter_image_recordio_2.cc`` exposed as
``mx.io.ImageRecordIter``).  The hot path is the port's own native decode
pool (``io/csrc/mxnet_io.cpp``, built by :mod:`._native`): RecordIO parse,
JPEG decode and augmentation in a C++ thread pool filling one float32 NCHW
host batch, which ``io.DataPipeline`` stages to the card.  Where the JAX
package falls back quietly to Pillow when its library cannot be built, the
port raises with the compiler's or loader's message: a silent fallback
would hide a decode ten times slower behind a passing run.  The Python
(Pillow) path stays for what the native pool does not take: ``C != 3``.

Distributed sharding: ``part_index``/``num_parts`` selects every k-th
record, the reference's multi-worker contract.
"""
from __future__ import annotations

import ctypes

import numpy as _np

from . import _native
from .io import DataBatch, DataDesc, DataIter, host_array

__all__ = ["ImageRecordIter"]

_F_PTR = ctypes.POINTER(ctypes.c_float)


class ImageRecordIter(DataIter):
    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, resize=0,
                 preprocess_threads=4, seed=0, part_index=0, num_parts=1,
                 data_name="data", label_name="softmax_label",
                 round_batch=True, **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3, "data_shape must be (C, H, W)"
        self._shape = tuple(data_shape)
        self._data_name = data_name
        self._label_name = label_name
        c, h, w = data_shape
        self._mean = _np.array([mean_r, mean_g, mean_b], dtype=_np.float32)
        self._std = _np.array([std_r, std_g, std_b], dtype=_np.float32)
        self._handle = None
        self._lib = None
        self._round_batch = round_batch
        if c == 3:  # the native pool is RGB-only
            self._lib = _native.load()
            handle = self._lib.MXTImageIterCreate(
                path_imgrec.encode(), batch_size, h, w, c,
                preprocess_threads, int(shuffle), seed,
                part_index, num_parts,
                self._mean.ctypes.data_as(_F_PTR), self._std.ctypes.data_as(_F_PTR),
                int(rand_mirror), int(rand_crop), int(resize))
            if not handle:
                raise IOError(f"native decode pool could not open {path_imgrec!r}")
            self._handle = ctypes.c_void_p(handle)
        else:
            self._py_init(path_imgrec, shuffle, seed, part_index, num_parts,
                          rand_crop, rand_mirror, resize)
        self._pending = None

    @property
    def native(self):
        """Whether batches come from the native decode pool (False only on
        the Python path of ``C != 3``)."""
        return self._handle is not None

    @property
    def decoder(self):
        """The JPEG decoder of the batches: ``"libjpeg"`` or ``"nvjpeg"``
        (the native pool's build), ``"pillow"`` on the Python path."""
        return _native.decoder() if self.native else "pillow"

    @property
    def num_samples(self):
        if self._handle is not None:
            return int(self._lib.MXTImageIterNumSamples(self._handle))
        return len(self._py_offsets)

    def _buffers(self):
        c, h, w = self._shape
        return (_np.empty((self.batch_size, c, h, w), dtype=_np.float32),
                _np.empty((self.batch_size,), dtype=_np.float32))

    # ---------------- native path ----------------
    def _native_next(self, data, label):
        return self._lib.MXTImageIterNext(self._handle, data.ctypes.data_as(_F_PTR),
                                          label.ctypes.data_as(_F_PTR))

    # ---------------- python path (C != 3) ----------------
    def _py_init(self, path, shuffle, seed, part_index, num_parts,
                 rand_crop, rand_mirror, resize):
        from ..recordio import MXRecordIO
        self._py_rec_path = path
        self._py_offsets = []
        r = MXRecordIO(path, "r")
        pos = r.tell()
        i = 0
        while True:
            payload = r.read()
            if payload is None:
                break
            if i % num_parts == part_index:
                self._py_offsets.append(pos)
            pos = r.tell()
            i += 1
        self._py_reader = r  # persistent seek-based read handle
        self._py_rng = _np.random.RandomState(seed)
        self._py_shuffle = shuffle
        self._py_aug = (rand_crop, rand_mirror, resize)
        self._py_order = _np.arange(len(self._py_offsets))
        self._py_cursor = 0
        if shuffle:
            self._py_rng.shuffle(self._py_order)

    def _py_next(self, data, label):
        from ..recordio import unpack_img
        c, h, w = self._shape
        remaining = len(self._py_order) - self._py_cursor
        if remaining <= 0:
            return 0
        n = min(self.batch_size, remaining)
        rand_crop, rand_mirror, resize = self._py_aug
        r = self._py_reader
        for i in range(n):
            off = self._py_offsets[self._py_order[self._py_cursor + i]]
            r.fh.seek(off)
            header, img = unpack_img(r.read(), iscolor=1 if c == 3 else 0)
            img = self._py_augment(img, h, w, rand_crop, rand_mirror, resize)
            arr = img.astype(_np.float32)
            arr = (arr - self._mean[:c]) / self._std[:c]
            data[i] = arr.transpose(2, 0, 1)
            lab = header.label
            label[i] = float(lab if _np.isscalar(lab) else _np.asarray(lab).ravel()[0])
        self._py_cursor += n
        return n

    def _py_augment(self, img, h, w, rand_crop, rand_mirror, resize):
        from PIL import Image
        ih, iw = img.shape[:2]
        min_side = resize
        if min_side <= 0 and (ih < h or iw < w):
            min_side = max(h, w)
        if min_side > 0:
            scale = min_side / min(ih, iw)
            nh, nw = max(int(ih * scale + 0.5), h), max(int(iw * scale + 0.5), w)
            img = _np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
            ih, iw = nh, nw
        elif ih < h or iw < w:
            img = _np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
            ih, iw = h, w
        if rand_crop:
            y0 = self._py_rng.randint(0, ih - h + 1)
            x0 = self._py_rng.randint(0, iw - w + 1)
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        img = img[y0:y0 + h, x0:x0 + w]
        if rand_mirror and self._py_rng.randint(2):
            img = img[:, ::-1]
        return img

    # ---------------- DataIter contract ----------------
    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size,) + self._shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def reset(self):
        self._pending = None
        if self._handle is not None:
            self._lib.MXTImageIterReset(self._handle)
        else:
            self._py_cursor = 0
            if self._py_shuffle:
                self._py_rng.shuffle(self._py_order)

    def next(self):
        if self._pending is not None:  # batch fetched by iter_next()
            batch, self._pending = self._pending, None
            return batch
        data, label = self._buffers()  # fresh each batch: the caller owns it
        n = self._native_next(data, label) if self._handle is not None \
            else self._py_next(data, label)
        if n == 0:
            raise StopIteration
        pad = self.batch_size - n
        if pad and not self._round_batch:
            raise StopIteration
        if pad:  # wrap-pad the tail batch (parity: round_batch)
            for i in range(n, self.batch_size):
                data[i] = data[i - n]
                label[i] = label[i - n]
        return DataBatch([host_array(data)], [host_array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    # DataIter protocol: iter_next + getdata/getlabel/getpad
    def iter_next(self):
        if self._pending is not None:
            return True
        try:
            self._pending = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        assert self._pending is not None, "call iter_next() first"
        return self._pending.data

    def getlabel(self):
        assert self._pending is not None, "call iter_next() first"
        return self._pending.label

    def getpad(self):
        return self._pending.pad if self._pending is not None else 0

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            try:
                self._lib.MXTImageIterFree(self._handle)
            except Exception:
                pass
