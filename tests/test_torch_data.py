"""The port's host data pipeline against the JAX package's: byte-equal.

The augment functions (HSV, flips, affine with and without perspective,
resize, normalize, mosaic, mixup, the train and eval transforms) get the
same inputs and equally seeded generators; the COCO dataset and the
loader's batches (train with mosaic/mixup/HSV/affine/flips for epochs 0 and
1, a mid-epoch ``start_step``, multiscale, and eval) are compared array by
array with ``assert_array_equal``.
"""

import numpy as np
import pytest

from tests.make_fixtures import make_coco_dataset
from yolo_ms_tpu.data import augment as ja
from yolo_ms_tpu.data.coco import CocoDetectionDataset as JaxDataset
from yolo_ms_tpu.data.loader import DetectionLoader as JaxLoader
from yolo_ms_tpu_torch.data import augment as ta
from yolo_ms_tpu_torch.data.coco import CocoDetectionDataset
from yolo_ms_tpu_torch.data.coco_classes import COCO_CLASSES
from yolo_ms_tpu_torch.data.loader import DetectionLoader

AUG = {
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 5.0, "translate": 0.1,
    "scale": 0.5, "shear": 2.0, "fliplr": 0.5, "flipud": 0.2, "mosaic": 1.0, "mixup": 0.5,
}


def _equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _sample(seed, h=72, w=96, n=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, [w - 20, h - 20], (n, 2))
    wh = rng.uniform(8, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    return img, boxes, labels


@pytest.mark.parametrize("name", [
    "hsv_jitter", "horizontal_flip", "vertical_flip", "random_affine",
    "random_affine_perspective", "resize_linear", "normalize_imagenet", "letterbox",
])
def test_augment_function_byte_equal(name):
    img, boxes, labels = _sample(0)

    def run(mod):
        rng = np.random.default_rng(7)
        if name == "hsv_jitter":
            return mod.hsv_jitter(img, rng, 0.015, 0.7, 0.4)
        if name == "horizontal_flip":
            return mod.horizontal_flip(img, boxes)
        if name == "vertical_flip":
            return mod.vertical_flip(img, boxes)
        if name == "random_affine":
            return mod.random_affine(img, boxes, labels, rng, degrees=10, translate=0.2,
                                     scale=0.5, shear=3)
        if name == "random_affine_perspective":
            return mod.random_affine(img, boxes, labels, rng, degrees=10, scale=0.3,
                                     perspective=1e-3)
        if name == "resize_linear":
            return mod.resize_linear(img, boxes, 50, 64)
        if name == "normalize_imagenet":
            return mod.normalize_imagenet(img)
        return mod.letterbox(img, boxes, 64, 64)

    _equal(run(ta), run(ja))


def test_mosaic_and_mixup_byte_equal():
    samples = [_sample(s, h=40 + 8 * s, w=90 - 10 * s) for s in range(4)]
    for seed in range(3):
        want = ja.mosaic4(samples, np.random.default_rng(seed), 64)
        got = ta.mosaic4(samples, np.random.default_rng(seed), 64)
        _equal(got, want)
    (i1, b1, l1), (i2, b2, l2) = _sample(5), _sample(6)
    _equal(ta.mixup(i1, b1, l1, i2, b2, l2, np.random.default_rng(1)),
           ja.mixup(i1, b1, l1, i2, b2, l2, np.random.default_rng(1)))


def test_transforms_byte_equal():
    img, boxes, labels = _sample(3)
    for seed in range(4):
        _equal(ta.TrainAugment(AUG, (64, 64))(img, boxes, labels, np.random.default_rng(seed)),
               ja.TrainAugment(AUG, (64, 64))(img, boxes, labels, np.random.default_rng(seed)))
    _equal(ta.EvalTransform((48, 64))(img, boxes, labels),
           ja.EvalTransform((48, 64))(img, boxes, labels))
    assert list(COCO_CLASSES) == list(__import__(
        "yolo_ms_tpu.data.coco_classes", fromlist=["COCO_CLASSES"]).COCO_CLASSES)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return make_coco_dataset(root, num_images=10, num_classes=3, img_w=120, img_h=90, seed=4)


def test_dataset_items_equal(coco):
    images, ann = coco
    jds = JaxDataset(images, ann, num_classes=3, verbose=False)
    tds = CocoDetectionDataset(images, ann, num_classes=3, verbose=False)
    assert len(tds) == len(jds) == 10
    for i in range(len(tds)):
        _equal(tuple(tds[i]), tuple(jds[i]))


def _loaders(coco, **kw):
    images, ann = coco
    args = dict(batch_size=4, img_size=(64, 64), max_gt=8, seed=3, num_workers=2,
                device_normalize=True)
    args.update(kw)
    return (DetectionLoader(CocoDetectionDataset(images, ann, 3, verbose=False), **args),
            JaxLoader(JaxDataset(images, ann, 3, verbose=False), **args))


def _batches_equal(port, jax_loader, epoch, start_step=0):
    got = list(port.epoch(epoch, start_step=start_step))
    want = list(jax_loader.epoch(epoch, start_step=start_step))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _equal(g[k], w[k])
    return got


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_batches_byte_equal(coco, epoch):
    port, jl = _loaders(coco, is_train=True, augmentation=AUG)
    got = _batches_equal(port, jl, epoch)
    assert len(port) == len(jl) == 2
    assert got[0]["images"].dtype == np.uint8
    assert all(b["mask"].any() for b in got)


def test_start_step_resumes_the_same_batches(coco):
    port, jl = _loaders(coco, is_train=True, augmentation=AUG)
    full = list(port.epoch(1))
    resumed = _batches_equal(port, jl, 1, start_step=1)
    for k in full[1]:
        _equal(resumed[0][k], full[1][k])


def test_multiscale_batches_byte_equal(coco):
    port, jl = _loaders(coco, is_train=True, augmentation={"fliplr": 0.5, "mosaic": 0.5},
                        batch_size=2, multiscale_sizes=[32, 64, 96], multiscale_interval=1)
    for epoch in (0, 1):
        got = _batches_equal(port, jl, epoch)
        assert len({b["images"].shape[1] for b in got}) > 1  # sizes vary per batch
    _batches_equal(port, jl, 0, start_step=3)


@pytest.mark.parametrize("normalize", [True, False])
def test_eval_batches_byte_equal(coco, normalize):
    port, jl = _loaders(coco, is_train=False, device_normalize=normalize, drop_last=False)
    got = _batches_equal(port, jl, 0)
    assert [b["num_valid"] for b in got] == [4, 4, 2]


def test_multi_process_feed_raises(coco):
    images, ann = coco
    ds = CocoDetectionDataset(images, ann, 3, verbose=False)
    with pytest.raises(NotImplementedError):
        DetectionLoader(ds, batch_size=4, process_shard=(0, 2))
    with pytest.raises(NotImplementedError):
        DetectionLoader(ds, batch_size=4, is_train=False, shard_images_only=True)
    assert len(DetectionLoader(ds, batch_size=4, process_shard=(0, 1))) == 2


def test_failed_batch_raises_in_the_consumer(coco):
    port, _ = _loaders(coco, is_train=True, augmentation=AUG)

    def broken(*args, **kwargs):
        raise OSError("unreadable image")

    port._make_sample = broken
    with pytest.raises(OSError, match="unreadable"):
        list(port.epoch(0))
