"""The detection image pipeline of the PyTorch port against the JAX
package, on the CPU: ``DetBorrowAug``, ``DetHorizontalFlipAug`` at p = 0
and p = 1, ``DetRandomCropAug`` with its draws fixed by seeding numpy's
global generator before each side (both draw from it in the same order),
``CreateDetAugmenter``'s chain and ``ImageDetIter`` (shuffled, a padded
last batch, empty labels), batch for batch.  Images and boxes must match
exactly: both sides run the same numpy arithmetic and Pillow's resize.
The port's batches are CPU NDArrays, as ``mx.io``'s are, and feed
``multibox_target``.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.image import detection as jdet
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.image import detection as tdet
from incubator_mxnet_torch.ops.detection import multibox_prior, multibox_target


def _sample(seed=0, h=60, w=80, boxes=2):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h, w, 3), np.uint8)
    label = np.full((4, 5), -1.0, np.float32)
    rows = [[1, 0.10, 0.20, 0.50, 0.60], [3, 0.55, 0.30, 0.90, 0.80],
            [0, 0.30, 0.05, 0.70, 0.45]]
    label[:boxes] = rows[:boxes]
    return img, label


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _run_both(make_aug, img, label, seed):
    """Apply the JAX and the port augmenter with numpy's generator at the
    same seed; returns ((image, label) JAX, (image, label) port)."""
    np.random.seed(seed)
    want = make_aug(jdet)(img, label)
    np.random.seed(seed)
    got = make_aug(tdet)(img, label)
    return [(_np(a), _np(b)) for a, b in (want, got)]


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_flip_matches_jax(p):
    img, label = _sample()
    (wi, wl), (gi, gl) = _run_both(lambda m: m.DetHorizontalFlipAug(p), img, label, 0)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gi, img[:, ::-1] if p else img)
    assert gl[2, 0] == -1  # padding untouched


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_random_crop_with_fixed_draws_matches_jax(seed):
    img, label = _sample(seed=1, boxes=3)
    (wi, wl), (gi, gl) = _run_both(
        lambda m: m.DetRandomCropAug(min_object_covered=0.5, area_range=(0.4, 0.9)),
        img, label, seed)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    valid = gl[gl[:, 0] >= 0]
    assert len(valid) >= 1 and (valid[:, 1:5] >= 0).all() and (valid[:, 1:5] <= 1).all()


def test_borrow_aug_and_created_chain_match_jax():
    """``CreateDetAugmenter(resize, rand_crop, rand_mirror, mean, std)``:
    the same augmenter types in the same order, and the same image and
    boxes through the chain."""
    kw = dict(resize=48, rand_crop=1, rand_mirror=True, mean=np.array([120., 110., 100.]),
              std=np.array([50., 60., 70.]))
    jaugs = jdet.CreateDetAugmenter((3, 32, 40), **kw)
    taugs = tdet.CreateDetAugmenter((3, 32, 40), **kw)
    assert [type(a).__name__ for a in taugs] == [type(a).__name__ for a in jaugs]
    assert [type(a.augmenter).__name__ for a in taugs if isinstance(a, tdet.DetBorrowAug)] == \
        [type(a.augmenter).__name__ for a in jaugs if isinstance(a, jdet.DetBorrowAug)]
    img, label = _sample(seed=2, boxes=3)
    outs = []
    for augs in (jaugs, taugs):
        np.random.seed(5)
        x, lab = img, label
        for aug in augs:
            x, lab = aug(x, lab)
        outs.append((_np(x), lab))
    (wi, wl), (gi, gl) = outs
    assert gi.shape == wi.shape == (32, 40, 3)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


def _drain(it):
    return [(_np(b.data[0]), _np(b.label[0])) for b in it]


@pytest.mark.parametrize("kw", [
    dict(rand_mirror=True, rand_crop=1, mean=np.array([0.5, 0.5, 0.5], np.float32)),
    dict(shuffle=True, rand_mirror=True),
    dict(),
], ids=["mirror_crop_mean", "shuffle_mirror", "plain"])
def test_image_det_iter_matches_jax_batch_for_batch(kw):
    """7 samples in batches of 3: two full batches and a last one padded by
    wrapping to the epoch's start, over two epochs."""
    samples = [(_sample(seed=i, boxes=1 + i % 3)[1], _sample(seed=i)[0]) for i in range(7)]
    runs = []
    for mod in (jdet, tdet):
        np.random.seed(9)
        it = mod.ImageDetIter(samples, batch_size=3, data_shape=(3, 32, 32), max_objects=4,
                              **kw)
        runs.append(_drain(it) + _drain(it))
    want, got = runs
    assert len(got) == len(want) == 6
    for (wd, wl), (gd, gl) in zip(want, got):
        assert gd.shape == (3, 3, 32, 32) and gl.shape == (3, 4, 5)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_batches_are_cpu_ndarrays_and_feed_multibox_target():
    samples = [(np.array([[1, 0.1, 0.1, 0.6, 0.6]], np.float32), _sample(seed=9)[0])
               for _ in range(2)]
    batch = next(iter(mx.image.ImageDetIter(samples, batch_size=2, data_shape=(3, 32, 32),
                                            max_objects=4)))
    data, label = batch.data[0], batch.label[0]
    assert isinstance(data, mx.nd.NDArray) and isinstance(label, mx.nd.NDArray)
    assert data.context == mx.cpu() and label.context == mx.cpu()
    anchors = multibox_prior(torch.zeros(1, 3, 8, 8), sizes=(0.5,), ratios=(1.0,))
    bt, bm, ct = multibox_target(anchors, label._data, torch.zeros(2, 3, anchors.shape[1]))
    assert torch.isfinite(bt).all() and int((ct > 0).sum()) > 0


def test_empty_labels_partial_batch_and_oversized_batch():
    rng = np.random.RandomState(1)
    samples = [([], rng.randint(0, 255, (40, 40, 3), np.uint8)) for _ in range(5)]
    batches = list(tdet.ImageDetIter(samples, batch_size=2, data_shape=(3, 16, 16),
                                     max_objects=3))
    assert len(batches) == 3
    assert (_np(batches[-1].label[0])[:, :, 0] == -1).all()
    img, label = _sample()
    with pytest.raises(ValueError, match="exceeds dataset size"):
        tdet.ImageDetIter([(label, img)], batch_size=4, data_shape=(3, 16, 16))
    assert mx.image.ImageDetIter is tdet.ImageDetIter
    assert mxj.image.ImageDetIter is jdet.ImageDetIter
