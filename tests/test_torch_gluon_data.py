"""``gluon.data`` and ``mx.image`` of the port against the JAX package's, on
the CPU.

Datasets (the array ones, records, image folders, the vision sets from
local files and their synthetic stand-ins), the five samplers, the
``DataLoader`` (no workers, 2 process workers, 2 threads, pinned batches),
the vision transforms and the ``mx.image`` functions and augmenters on
seeded images.  Tolerances: exact everywhere but ``ToTensor``/``Normalize``
(1e-6: the JAX package's compiled call multiplies by a reciprocal where
the port divides) and the linear resize of ``Resize``/``RandomResizedCrop``,
where the two packages' filters agree to 1e-4 before rounding, so a pixel
may round one level apart (at most 1 % of them).
"""
import gzip
import os
import pickle
import random
import struct
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_tpu.gluon.data.vision import transforms as JT
from incubator_mxnet_torch.gluon.data.vision import transforms as TT

tdata, jdata = mx.gluon.data, mxj.gluon.data


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _img(h=20, w=24, seed=0, dtype=np.uint8):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(dtype)


# -- datasets -----------------------------------------------------------------


def test_array_and_simple_datasets_and_their_views():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    y = np.arange(10)
    for pkg in (tdata, jdata):
        ds = pkg.ArrayDataset(x, y)
        assert len(ds) == 10 and ds[3][1] == 3
        assert [int(b) for _, b in ds.shard(3, 1)] == [1, 4, 7]
        assert len(ds.take(4)) == 4 and len(ds.filter(lambda s: s[1] % 2 == 0)) == 5
        t = ds.transform_first(lambda a: a * 2)
        np.testing.assert_array_equal(t[2][0], x[2] * 2)
        assert len(pkg.SimpleDataset([1, 2, 3]).transform(lambda v: v + 1)) == 3
    with pytest.raises(AssertionError):
        tdata.ArrayDataset(x, y[:5])


def test_transform_first_pickles_for_process_workers():
    ds = tdata.ArrayDataset(np.ones((4, 2), np.float32), np.arange(4)).transform_first(
        TT.Cast("float16"))
    again = pickle.loads(pickle.dumps(ds))
    assert again[1][0].dtype == torch.float16 and again[1][1] == 1


def test_record_file_and_image_record_datasets_match_jax(tmp_path):
    rec = str(tmp_path / "d.rec")
    w = mx.recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"), rec, "w")
    for i in range(5):
        w.write_idx(i, mx.recordio.pack_img(mx.recordio.IRHeader(0, float(i), i, 0),
                                            _img(seed=i), quality=95))
    w.close()
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 5 and t[3] == j[3]
    for flag in (1, 0):
        ti = tdata.vision.ImageRecordDataset(rec, flag=flag)
        ji = jdata.vision.ImageRecordDataset(rec, flag=flag)
        for i in range(5):
            (a, la), (b, lb) = ti[i], ji[i]
            _eq(a, b)
            assert float(la) == float(lb) == i and a.context == mx.cpu()


def test_image_folder_dataset_matches_jax(tmp_path):
    from PIL import Image

    for c, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(2):
            Image.fromarray(_img(seed=10 * c + i)).save(tmp_path / cls / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not a class")
    t = tdata.vision.ImageFolderDataset(str(tmp_path))
    j = jdata.vision.ImageFolderDataset(str(tmp_path))
    assert t.synsets == j.synsets == ["cat", "dog"] and len(t) == 4
    for i in range(4):
        _eq(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">i", 0x0800 + arr.ndim))
        f.write(struct.pack(">" + "i" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_mnist_from_local_files_matches_jax(tmp_path, name):
    rng = np.random.RandomState(1)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte.gz", rng.randint(0, 255, (7, 28, 28)))
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte.gz", rng.randint(0, 10, (7,)))
    t = getattr(tdata.vision, name)(root=str(tmp_path), train=False)
    j = getattr(jdata.vision, name)(root=str(tmp_path), train=False)
    assert len(t) == len(j) == 7
    for i in (0, 6):
        _eq(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]


@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100"])
def test_cifar_from_local_files_matches_jax(tmp_path, name):
    batch_dir = tmp_path / "cifar-10-batches-py"
    batch_dir.mkdir()
    rng = np.random.RandomState(2)
    key = b"labels" if name == "CIFAR10" else b"fine_labels"
    with open(batch_dir / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.randint(0, 255, (6, 3072)).astype(np.uint8),
                     key: list(rng.randint(0, 10, (6,)))}, f)
    t = getattr(tdata.vision, name)(root=str(tmp_path), train=False)
    j = getattr(jdata.vision, name)(root=str(tmp_path), train=False)
    assert len(t) == len(j) == 6
    for i in (0, 5):
        _eq(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]


@pytest.mark.parametrize("name", ["MNIST", "CIFAR10"])
def test_synthetic_stand_ins_match_jax(tmp_path, name):
    t = getattr(tdata.vision, name)(root=str(tmp_path / "absent"), train=False)
    j = getattr(jdata.vision, name)(root=str(tmp_path / "absent"), train=False)
    assert len(t) == len(j) == 1000
    for i in (0, 17, 999):
        _eq(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]
    tt = getattr(tdata.vision, name)(root=str(tmp_path / "absent"), train=False,
                                     transform=lambda d, lab: (d, lab + 100))
    assert tt[0][1] == t[0][1] + 100


def test_synthetic_image_dataset_matches_jax():
    t = tdata.vision.SyntheticImageDataset(num_samples=6, shape=(8, 8, 3), classes=10, seed=4)
    j = jdata.vision.SyntheticImageDataset(num_samples=6, shape=(8, 8, 3), classes=10, seed=4)
    assert len(t) == 6
    for i in range(6):
        _eq(t[i][0], j[i][0])
        assert t[i][1] == j[i][1] and t[i][0].context == mx.cpu()


# -- samplers -----------------------------------------------------------------


def test_samplers_match_jax():
    for pkg_t, pkg_j in ((tdata, jdata),):
        assert list(pkg_t.SequentialSampler(5, start=2)) == list(pkg_j.SequentialSampler(5, 2))
        np.random.seed(3)
        a = list(pkg_t.RandomSampler(9))
        np.random.seed(3)
        assert a == list(pkg_j.RandomSampler(9)) and sorted(a) == list(range(9))
        ds = list(range(10))
        assert list(pkg_t.FilterSampler(lambda v: v % 3 == 0, ds)) == [0, 3, 6, 9]
        for last in ("keep", "discard", "rollover"):
            t = pkg_t.BatchSampler(pkg_t.SequentialSampler(7), 3, last)
            j = pkg_j.BatchSampler(pkg_j.SequentialSampler(7), 3, last)
            assert [list(t), list(t)] == [list(j), list(j)] and len(t) == len(j)
        with pytest.raises(ValueError, match="odd"):
            list(pkg_t.BatchSampler(pkg_t.SequentialSampler(5), 2, "odd"))


# -- the DataLoader -----------------------------------------------------------


def _dataset(n=22):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 3, 4).astype(np.float32), rng.randint(0, 5, (n,)).astype(np.int32))


@pytest.mark.parametrize("kw", [dict(batch_size=4), dict(batch_size=5, last_batch="discard"),
                                dict(batch_size=6, last_batch="rollover"),
                                dict(batch_size=4, num_workers=2, thread_pool=True)],
                         ids=["keep", "discard", "rollover", "threads"])
def test_dataloader_matches_jax(kw):
    x, y = _dataset()
    t = tdata.DataLoader(tdata.ArrayDataset(x, y), **kw)
    j = jdata.DataLoader(jdata.ArrayDataset(x, y), **kw)
    assert len(t) == len(j)
    got, want = [_np(b) for b in t], [_np(b) for b in j]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)
    b = next(iter(t))
    assert b[0].context == mx.cpu()


def test_dataloader_shuffles_as_jax():
    x, y = _dataset()
    np.random.seed(5)
    got = [_np(b) for b in tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4, shuffle=True)]
    np.random.seed(5)
    want = [_np(b) for b in jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=4,
                                             shuffle=True)]
    for g, w in zip(got, want):
        _eq(g, w)


def test_dataloader_process_workers_match_no_workers():
    """Two spawned workers over NDArray samples transformed by ToTensor and
    Normalize: the same batches as the loop in this process."""
    ds = tdata.vision.SyntheticImageDataset(num_samples=12, shape=(8, 8, 3), seed=1)
    ds = ds.transform_first(TT.Compose([TT.ToTensor(), TT.Normalize(0.5, 0.25)]))
    ref = [_np(b) for b in tdata.DataLoader(ds, batch_size=5)]
    got = [_np(b) for b in tdata.DataLoader(ds, batch_size=5, num_workers=2, prefetch=2)]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _eq(g, r)


def test_dataloader_argument_rules_and_custom_batchify():
    x, y = _dataset(8)
    ds = tdata.ArrayDataset(x, y)
    with pytest.raises(ValueError, match="batch_size must be specified"):
        tdata.DataLoader(ds)
    with pytest.raises(ValueError, match="shuffle must not"):
        tdata.DataLoader(ds, batch_size=2, shuffle=True, sampler=tdata.SequentialSampler(8))
    bs = tdata.BatchSampler(tdata.SequentialSampler(8), 3)
    with pytest.raises(ValueError, match="must not be specified"):
        tdata.DataLoader(ds, batch_size=2, batch_sampler=bs)
    out = list(tdata.DataLoader(ds, batch_sampler=bs, batchify_fn=lambda s: len(s)))
    assert out == [3, 3, 2]


def test_pin_memory_without_a_card_warns_and_stays_pageable():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    x, y = _dataset(4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b = next(iter(tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=2,
                                       pin_memory=True)))
    assert any("pin_memory" in str(w.message) for w in caught)
    assert not b[0]._data.is_pinned() and b[0].context == mx.cpu()


def test_pin_marks_batches_cpu_pinned(monkeypatch):
    """The pinning step itself: each NDArray's tensor pinned, the context
    ``cpu_pinned`` (``Tensor.pin_memory`` stands in here, with no card)."""
    from incubator_mxnet_torch.gluon.data import dataloader

    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: t.clone())
    batch = (mx.nd.array(np.ones((2, 2)), ctx=mx.cpu()), torch.zeros(2))
    out = dataloader._pin(batch)
    assert out[0].context == mx.cpu_pinned() and torch.equal(out[0]._data, batch[0]._data)
    assert isinstance(out[1], torch.Tensor)


# -- vision transforms --------------------------------------------------------


def _both(make, x, seed=0):
    np.random.seed(seed)
    random.seed(seed)
    got = make(TT)(mx.nd.array(x, ctx=mx.cpu(), dtype=x.dtype.name))
    np.random.seed(seed)
    random.seed(seed)
    want = make(JT)(mxj.nd.array(x, dtype=x.dtype.name))
    return _np(got), _np(want), got


EXACT = {
    "cast": lambda T: T.Cast("float16"),
    "center_crop": lambda T: T.CenterCrop((10, 8)),
    "random_crop": lambda T: T.RandomCrop(12, pad=2),
    "flip_lr": lambda T: T.RandomFlipLeftRight(p=0.9),
    "flip_tb": lambda T: T.RandomFlipTopBottom(p=0.9),
    "brightness": lambda T: T.RandomBrightness(0.4),
    "contrast": lambda T: T.RandomContrast(0.4),
    "saturation": lambda T: T.RandomSaturation(0.4),
    "hue": lambda T: T.RandomHue(0.3),
    "lighting": lambda T: T.RandomLighting(0.3),
    "color_jitter": lambda T: T.RandomColorJitter(0.3, 0.3, 0.3, 0.2),
}


@pytest.mark.parametrize("name", sorted(EXACT))
@pytest.mark.parametrize("seed", [0, 1])
def test_transforms_match_jax_exactly(name, seed):
    got, want, out = _both(EXACT[name], _img(seed=seed), seed=seed)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert isinstance(out, mx.nd.NDArray) and out.context == mx.cpu()


# The JAX package's compiled transform multiplies by the divisor's
# reciprocal from its second call on (its first divides); the port divides:
# one fp32 rounding apart, 1e-6 of the [0, 1] values (a few ulps after
# Normalize's subtraction).
FLOAT = {
    "to_tensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize([0.4, 0.5, 0.6],
                                                                [0.2, 0.3, 0.25])]),
}


@pytest.mark.parametrize("name", sorted(FLOAT))
@pytest.mark.parametrize("seed", [0, 1])
def test_float_transforms_match_jax_to_a_rounding(name, seed):
    got, want, out = _both(FLOAT[name], _img(seed=seed), seed=seed)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ref = _img(seed=seed).astype(np.float32).transpose(2, 0, 1) / np.float32(255)
    if name == "to_tensor":  # the port divides
        np.testing.assert_array_equal(got, ref)
    assert isinstance(out, mx.nd.NDArray)


RESAMPLE = {
    "resize_down": lambda T: T.Resize((13, 9)),
    "resize_up": lambda T: T.Resize(40),
    "random_resized_crop": lambda T: T.RandomResizedCrop(16),
}


@pytest.mark.parametrize("name", sorted(RESAMPLE))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resampling_transforms_match_jax_within_a_level(name, seed):
    got, want, _ = _both(RESAMPLE[name], _img(31, 27, seed=seed), seed=seed)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_transforms_on_tensors_and_batches():
    x = torch.from_numpy(_img(8, 8))
    out = TT.ToTensor()(x)
    assert isinstance(out, torch.Tensor) and out.shape == (3, 8, 8)
    batch = TT.ToTensor()(torch.stack([x, x]))
    assert batch.shape == (2, 3, 8, 8)
    assert TT.Normalize(0.5, 0.5)(batch).shape == (2, 3, 8, 8)


# -- mx.image -----------------------------------------------------------------


def test_imdecode_imread_and_resizes_match_jax(tmp_path):
    from PIL import Image

    img = _img(30, 40, seed=3)
    Image.fromarray(img).save(tmp_path / "a.png")
    buf = (tmp_path / "a.png").read_bytes()
    for flag, to_rgb in ((1, True), (1, False), (0, True)):
        _eq(mx.image.imdecode(buf, flag=flag, to_rgb=to_rgb),
            mxj.image.imdecode(buf, flag=flag, to_rgb=to_rgb))
    _eq(mx.image.imread(str(tmp_path / "a.png")), mxj.image.imread(str(tmp_path / "a.png")))
    src_t, src_j = mx.nd.array(img, ctx=mx.cpu(), dtype="uint8"), mxj.nd.array(img, dtype="uint8")
    _eq(mx.image.imresize(src_t, 17, 11), mxj.image.imresize(src_j, 17, 11))
    _eq(mx.image.imresize(src_t, 17, 11, interp=0), mxj.image.imresize(src_j, 17, 11, interp=0))
    f = img.astype(np.float32) / 3
    _eq(mx.image.imresize(f, 9, 7), mxj.image.imresize(f, 9, 7))
    _eq(mx.image.resize_short(src_t, 12), mxj.image.resize_short(src_j, 12))
    _eq(mx.image.fixed_crop(src_t, 2, 3, 10, 8, size=(5, 4)),
        mxj.image.fixed_crop(src_j, 2, 3, 10, 8, size=(5, 4)))
    ct, cj = mx.image.center_crop(src_t, (12, 9)), mxj.image.center_crop(src_j, (12, 9))
    _eq(ct[0], cj[0])
    assert ct[1] == cj[1]
    random.seed(4)
    rt = mx.image.random_crop(src_t, (12, 9))
    random.seed(4)
    rj = mxj.image.random_crop(src_j, (12, 9))
    _eq(rt[0], rj[0])
    assert rt[1] == rj[1]
    _eq(mx.image.color_normalize(src_t, [120.0, 110.0, 100.0], [50.0, 60.0, 70.0]),
        mxj.image.color_normalize(src_j, [120.0, 110.0, 100.0], [50.0, 60.0, 70.0]))
    out = mx.nd.array(np.zeros(1), ctx=mx.cpu())
    assert mx.image.imdecode(buf, out=out) is out and out.shape == (30, 40, 3)


AUGMENTERS = {
    "create_train": dict(data_shape=(3, 16, 16), resize=20, rand_crop=True, rand_mirror=True,
                         mean=True, std=True, brightness=0.3, contrast=0.3, saturation=0.3,
                         hue=0.2, pca_noise=0.1, rand_gray=0.5),
    "create_sized_crop": dict(data_shape=(3, 12, 12), rand_crop=True, rand_resize=True),
    "create_eval": dict(data_shape=(3, 16, 16), resize=18, mean=[1.0, 2.0, 3.0]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_create_augmenter_lists_match_jax(name, seed):
    img = _img(26, 30, seed=seed)
    outs = []
    for pkg, arr in ((mx, mx.nd.array(img, ctx=mx.cpu(), dtype="uint8")),
                     (mxj, mxj.nd.array(img, dtype="uint8"))):
        random.seed(seed)
        np.random.seed(seed)
        x = arr
        for aug in pkg.image.CreateAugmenter(**AUGMENTERS[name]):
            x = aug(x)
        outs.append(_np(x))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=0)
    assert outs[0].dtype == np.float32


def test_rand_resize_without_rand_crop_raises():
    with pytest.raises(ValueError, match="rand_crop"):
        mx.image.CreateAugmenter((3, 8, 8), rand_resize=True)


def test_image_iter_matches_jax(tmp_path):
    rec = str(tmp_path / "i.rec")
    w = mx.recordio.MXIndexedRecordIO(str(tmp_path / "i.idx"), rec, "w")
    for i in range(7):
        w.write_idx(i, mx.recordio.pack_img(mx.recordio.IRHeader(0, float(i % 3), i, 0),
                                            _img(20, 22, seed=i)))
    w.close()
    kw = dict(batch_size=3, data_shape=(3, 16, 16), path_imgrec=rec, shuffle=True,
              rand_crop=True, rand_mirror=True, mean=True)
    outs = []
    for pkg in (mx, mxj):
        random.seed(2)
        it = pkg.image.ImageIter(**kw)
        outs.append(_drain(it))
    assert len(outs[0]) == len(outs[1]) == 3
    for (a, la, pa), (b, lb, pb) in zip(*outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def _drain(it):
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append((_np(b.data[0]), _np(b.label[0]), b.pad))


def test_detection_names_wait_in_item_10():
    for name in ("ImageDetIter", "CreateDetAugmenter", "DetRandomCropAug"):
        with pytest.raises(AttributeError, match="item 10"):
            getattr(mx.image, name)
    assert not hasattr(mx.image, "no_such_name")
    assert os.path.basename(mx.image.__file__) == "__init__.py"
