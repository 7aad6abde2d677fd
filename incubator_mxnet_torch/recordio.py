"""``mx.recordio``: RecordIO pack/unpack.

Counterpart of the JAX package's ``recordio.py`` (parity target: MXNet's
``python/mxnet/recordio.py``: MXRecordIO/MXIndexedRecordIO, IRHeader,
pack/unpack/pack_img) over the dmlc-core framing.  Binary-compatible with
reference ``im2rec`` packs and with the JAX package's files byte for byte:
magic 0xced7230a, 29-bit length + 3-bit continuation flag, 4-byte
alignment.  The hot read path for training is the port's native decode
pool (``io/csrc/mxnet_io.cpp``); this module is the portable writer and
random-access reader.  Pillow is imported only by the image helpers.
"""
from __future__ import annotations

import collections
import struct

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "unpack_img", "pack_img"]

_MAGIC = 0xCED7230A
_LFLAG_BITS = 29


class MXRecordIO:
    """Sequential record reader/writer."""

    def __init__(self, uri, flag):
        assert flag in ("r", "w")
        self.uri = uri
        self.flag = flag
        self.fh = None
        self.open()

    def open(self):
        self.fh = open(self.uri, "rb" if self.flag == "r" else "wb")

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fh.tell()

    def write(self, buf):
        """Write one record (splitting continuation parts is unnecessary for
        the ≤512MB records the format allows; single-part framing used)."""
        assert self.flag == "w"
        n = len(buf)
        assert n < (1 << _LFLAG_BITS), "record too large"
        self.fh.write(struct.pack("<II", _MAGIC, n))
        self.fh.write(buf)
        pad = (4 - n % 4) % 4
        if pad:
            self.fh.write(b"\x00" * pad)

    def read(self):
        """Read next record payload or None at EOF."""
        assert self.flag == "r"
        payload = b""
        while True:
            head = self.fh.read(8)
            if len(head) < 8:
                return None if not payload else payload
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                return None
            cflag = lrec >> _LFLAG_BITS
            n = lrec & ((1 << _LFLAG_BITS) - 1)
            payload += self.fh.read(n)
            pad = (4 - n % 4) % 4
            if pad:
                self.fh.read(pad)
            if cflag in (0, 3):
                return payload


class MXIndexedRecordIO(MXRecordIO):
    """Random-access via a ``.idx`` text file of ``key\\toffset`` lines."""

    def __init__(self, idx_path, uri, flag):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self._idx_fh = None
        super().__init__(uri, flag)

    def open(self):
        """Reopen BOTH files so reset() keeps idx and rec in sync (write
        mode truncates both; the reference does the same)."""
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r":
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = int(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        else:
            self._idx_fh = open(self.idx_path, "w")

    def close(self):
        super().close()
        if getattr(self, "_idx_fh", None):
            self._idx_fh.close()
            self._idx_fh = None

    def read_idx(self, idx):
        self.fh.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        pos = self.tell()
        self.write(buf)
        self._idx_fh.write(f"{idx}\t{pos}\n")
        self.idx[idx] = pos
        self.keys.append(idx)


IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """IRHeader + payload → record bytes (parity: ``mx.recordio.pack``).
    ``header.flag > 0`` means ``label`` is a float vector of that length."""
    flag = header.flag
    label = header.label
    if isinstance(label, (list, tuple, _np.ndarray)):
        label_arr = _np.asarray(label, dtype=_np.float32)
        flag = label_arr.size
        hdr = struct.pack(_IR_FORMAT, flag, 0.0, header.id, header.id2)
        return hdr + label_arr.tobytes() + s
    hdr = struct.pack(_IR_FORMAT, flag, float(label), header.id, header.id2)
    return hdr + s


def unpack(s):
    """Record bytes → (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[: flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def unpack_img(s, iscolor=1):
    """Record bytes → (IRHeader, decoded HWC uint8 image) via PIL."""
    header, img_bytes = unpack(s)
    import io as _io

    from PIL import Image

    img = Image.open(_io.BytesIO(img_bytes))
    img = img.convert("RGB" if iscolor else "L")
    arr = _np.asarray(img)
    if not iscolor:
        arr = arr[..., None]  # keep HWC rank for grayscale
    return header, arr


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """(IRHeader, HWC uint8 array) → record bytes with encoded image."""
    import io as _io

    from PIL import Image

    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    Image.fromarray(_np.asarray(img, dtype=_np.uint8)).save(
        buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())
