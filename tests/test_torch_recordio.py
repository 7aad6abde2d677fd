"""``mx.recordio`` and ``mx.io.ImageRecordIter`` of the port against the JAX
package's, on the CPU.

Record files written by either package are byte-identical and read the
same in the other.  The port's native decode pool (its own copy of the
JAX package's C++ pool, built under ``build/native/``) gives batches
bit-equal to the JAX native pool's on the same ``.rec``: unaugmented at 4
threads, augmented at 1 (with more, the augmentation a record gets depends
on which thread claims it, in both packages), sharded and with vector
labels.  ``C != 3`` takes the Pillow path; a failed native build raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.io import record_iter as jrecord_iter
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import recordio as trec
from incubator_mxnet_torch.io import _native

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the smoke's record generator and bounds)


def _images(n, seed=0, gray=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rng.randint(36, 80), rng.randint(36, 80)
        out.append(rng.randint(0, 255, (h, w) if gray else (h, w, 3)).astype(np.uint8))
    return out


def _write(pkg, path, images, vector=False, quality=90):
    w = pkg.MXRecordIO(str(path), "w")
    for i, img in enumerate(images):
        label = [float(i % 7), float(i)] if vector else float(i % 7)
        w.write(pkg.pack_img(pkg.IRHeader(0, label, i, 0), img, quality=quality))
    w.close()


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    path = d / "imgs.rec"
    _write(trec, path, _images(22))
    vec = d / "vec.rec"
    _write(trec, vec, _images(10, seed=1), vector=True)
    return path, vec


def _jax_native():
    assert jrecord_iter._load_native() is not None, "the JAX package's native pool"


# -- the record format --------------------------------------------------------


def test_files_are_byte_identical(tmp_path):
    imgs = _images(5, seed=3)
    for vector in (False, True):
        _write(trec, tmp_path / "t.rec", imgs, vector)
        _write(jrec, tmp_path / "j.rec", imgs, vector)
        assert (tmp_path / "t.rec").read_bytes() == (tmp_path / "j.rec").read_bytes()
    w = trec.MXIndexedRecordIO(str(tmp_path / "ti.idx"), str(tmp_path / "ti.rec"), "w")
    j = jrec.MXIndexedRecordIO(str(tmp_path / "ji.idx"), str(tmp_path / "ji.rec"), "w")
    for i in (3, 9, 1):
        w.write_idx(i, f"payload{i}".encode() * i)
        j.write_idx(i, f"payload{i}".encode() * i)
    w.close()
    j.close()
    for ext in ("rec", "idx"):
        assert (tmp_path / f"ti.{ext}").read_bytes() == (tmp_path / f"ji.{ext}").read_bytes()


@pytest.mark.parametrize("writer,reader", [(trec, jrec), (jrec, trec)],
                         ids=["port_to_jax", "jax_to_port"])
def test_files_read_the_same_across_packages(tmp_path, writer, reader):
    imgs = _images(4, seed=5)
    _write(writer, tmp_path / "x.rec", imgs, vector=True)
    r = reader.MXRecordIO(str(tmp_path / "x.rec"), "r")
    for i, img in enumerate(imgs):
        header, got = reader.unpack_img(r.read())
        assert header.flag == 2 and header.id == i
        np.testing.assert_array_equal(header.label, [i % 7, i])
        assert got.shape == img.shape and got.dtype == np.uint8
    assert r.read() is None
    payloads = [b"", b"a", b"xyz" * 333]
    w = writer.MXRecordIO(str(tmp_path / "p.rec"), "w")
    for p in payloads:
        w.write(p)
    w.close()
    r = reader.MXRecordIO(str(tmp_path / "p.rec"), "r")
    assert [r.read() for _ in payloads] == payloads and r.read() is None


def test_pack_unpack_scalar_label_and_indexed_read(tmp_path):
    s = trec.pack(trec.IRHeader(0, 3.0, 42, 7), b"body")
    assert s == jrec.pack(jrec.IRHeader(0, 3.0, 42, 7), b"body")
    header, body = trec.unpack(s)
    assert tuple(header) == (0, 3.0, 42, 7) and body == b"body"
    w = trec.MXIndexedRecordIO(str(tmp_path / "i.idx"), str(tmp_path / "i.rec"), "w")
    for k in (5, 2, 8):
        w.write_idx(k, bytes([k]) * k)
    w.close()
    r = trec.MXIndexedRecordIO(str(tmp_path / "i.idx"), str(tmp_path / "i.rec"), "r")
    assert r.keys == [5, 2, 8] and r.read_idx(8) == bytes([8]) * 8 and r.read_idx(5) == b"\5" * 5
    r.reset()
    assert r.read() == b"\5" * 5


# -- ImageRecordIter ----------------------------------------------------------


def _run(it, epochs=2):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it])
    return out


def _assert_equal_runs(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for eg, ew in zip(got, want):
        for (gd, gl, gp), (wd, wl, wp) in zip(eg, ew):
            assert gp == wp and gd.dtype == wd.dtype == np.float32
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)


NORM = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
            std_b=57.375)
CASES = {
    "plain_4_threads": dict(preprocess_threads=4, **NORM),
    "shuffled_4_threads": dict(preprocess_threads=4, shuffle=True, seed=11),
    "augmented_1_thread": dict(preprocess_threads=1, shuffle=True, rand_crop=True,
                               rand_mirror=True, seed=3, **NORM),
    "resize_shorter": dict(preprocess_threads=2, resize=40),
    "shard_1_of_2": dict(preprocess_threads=4, num_parts=2, part_index=1),
    "no_round_batch": dict(preprocess_threads=4, round_batch=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_batches_bit_equal_to_jax_native(rec, case):
    _jax_native()
    kw = CASES[case]
    t = mx.io.ImageRecordIter(str(rec[0]), (3, 32, 32), 8, **kw)
    j = mxj.io.ImageRecordIter(str(rec[0]), (3, 32, 32), 8, **kw)
    assert t.native and t.decoder == "libjpeg" and j._handle is not None
    assert t.num_samples == j.num_samples
    _assert_equal_runs(_run(t), _run(j))
    assert t.provide_data[0].shape == (8, 3, 32, 32)


def test_vector_labels_take_the_first_element(rec):
    _jax_native()
    t = mx.io.ImageRecordIter(str(rec[1]), (3, 24, 24), 4, preprocess_threads=2)
    j = mxj.io.ImageRecordIter(str(rec[1]), (3, 24, 24), 4, preprocess_threads=2)
    got, want = _run(t, 1), _run(j, 1)
    _assert_equal_runs(got, want)
    labels = np.concatenate([lab for _, lab, _ in got[0]])
    np.testing.assert_array_equal(labels[:10], [i % 7 for i in range(10)])
    assert [pad for _, _, pad in got[0]] == [0, 0, 2]


def test_batches_are_cpu_ndarrays_the_caller_owns(rec):
    it = mx.io.ImageRecordIter(str(rec[0]), (3, 32, 32), 8)
    a, b = it.next(), it.next()
    assert a.data[0].context == mx.cpu() and a.label[0].dtype == np.float32
    assert a.data[0]._data.data_ptr() != b.data[0]._data.data_ptr()
    assert it.iter_next() and it.getpad() == 2 and it.getdata()[0].shape == (8, 3, 32, 32)


def test_grayscale_takes_the_pillow_path(tmp_path):
    _write(trec, tmp_path / "g.rec", _images(6, seed=2, gray=True))
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=4, mean_r=10.0, std_r=3.0)
    t = mx.io.ImageRecordIter(str(tmp_path / "g.rec"), (1, 24, 24), 4, **kw)
    j = mxj.io.ImageRecordIter(str(tmp_path / "g.rec"), (1, 24, 24), 4, **kw)
    assert not t.native and t.decoder == "pillow"
    _assert_equal_runs(_run(t), _run(j))


def test_a_failed_build_raises_with_the_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        _native.load()
    with pytest.raises(RuntimeError, match="not found"):
        mx.io.ImageRecordIter(str(tmp_path / "any.rec"), (3, 8, 8), 2)
    assert not (tmp_path / "native").exists()


def test_a_compile_error_raises_with_its_message(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native, "SRC", bad)
    monkeypatch.setattr(_native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed on .*bad.cpp"):
        _native.load()


def test_a_missing_record_file_raises(tmp_path):
    with pytest.raises(IOError, match="could not open"):
        mx.io.ImageRecordIter(str(tmp_path / "missing.rec"), (3, 8, 8), 2)


def test_the_library_is_built_under_build_native():
    path, decoder = _native.build()
    assert path.parent == ROOT / "build" / "native" and decoder == "libjpeg"
    assert not (ROOT / "native" / path.name).exists()


def test_the_smoke_records_decode_within_jpegs_loss(tmp_path):
    """chip_smoke.py's record file (its io_image generator at quality 90)
    decoded by the native pool against the source pixels: the bound the
    card's decoder is held to."""
    hw, crop, n = (375, 500), 224, 16
    labels, _ = chip_smoke.io_record_file(str(tmp_path / "s.rec"), n, hw, 1000)
    got = mx.io.ImageRecordIter(str(tmp_path / "s.rec"), (3, crop, crop), n).next()
    y0, x0 = (hw[0] - crop) // 2, (hw[1] - crop) // 2
    ref = np.stack([chip_smoke.io_image(i, hw, 1000)[0][y0:y0 + crop, x0:x0 + crop]
                    .transpose(2, 0, 1) for i in range(n)]).astype(np.float32)
    err = np.abs(got.data[0].asnumpy() - ref)
    assert err.mean() <= chip_smoke.IO_JPEG_MEAN_ERR / 2
    assert err.max() <= chip_smoke.IO_JPEG_MAX_ERR / 2
    np.testing.assert_array_equal(got.label[0].asnumpy(), labels)


def test_the_port_never_builds_into_native(tmp_path):
    """Importing and using the port leaves the JAX package's ``native/``
    as it was."""
    before = sorted(os.listdir(ROOT / "native"))
    code = ("import incubator_mxnet_torch as mx; import sys;"
            "sys.exit(0 if mx.io.ImageRecordIter.__name__ else 1)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0
    assert sorted(os.listdir(ROOT / "native")) == before
