"""The port's Predictor end to end on the CPU: both trained golden fixtures
reproduce their checked-in detections under the rule of
tests/test_trained_golden.py (same count, same class, IoU > 0.9, score
within 0.02), and the host pieces copied from the JAX package (normalize,
letterbox, decode) give the JAX package's outputs.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ms_tpu.data import augment as jax_augment
from yolo_ms_tpu.data import decode as jax_decode
from yolo_ms_tpu_torch.data import augment, decode
from yolo_ms_tpu_torch.infer.predictor import Predictor, draw_detections, find_images
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.utils.convert import load_npz

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = [("n", "trained"), ("yolo-ms-xs", "trained_yolo-ms-xs")]


def _iou_xyxy(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def _predictor(arch, sub, **kw):
    return Predictor(
        arch,
        load_npz(os.path.join(GOLDEN, sub, "weights.npz")),
        num_classes=3,
        class_names=["class_0", "class_1", "class_2"],
        input_size=(160, 160),
        conf_thresh=0.25,
        iou_thresh=0.45,
        device="cpu",
        **kw,
    )


@pytest.mark.parametrize("arch,sub", CASES)
def test_predictor_reproduces_golden_detections(tmp_path, arch, sub):
    gdir = os.path.join(GOLDEN, sub)
    _predictor(arch, sub).predict_paths(os.path.join(gdir, "fixture_000.png"), str(tmp_path))
    with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
        golden = json.load(f)
    with open(tmp_path / "fixture_000_detections.json") as f:
        got = json.load(f)
    assert len(got) == len(golden), (got, golden)
    unmatched = list(got)
    for g in golden:
        hit = None
        for d in unmatched:
            if (
                d["class_id"] == g["class_id"]
                and _iou_xyxy(d["box_xyxy"], g["box_xyxy"]) > 0.9
                and abs(d["score"] - g["score"]) < 0.02
            ):
                hit = d
                break
        assert hit is not None, f"golden detection unmatched: {g} in {got}"
        unmatched.remove(hit)
    assert os.path.exists(tmp_path / "fixture_000_detected.jpg")


def test_predictor_serves_a_folded_state_dict_as_it_is():
    sd = load_npz(os.path.join(GOLDEN, "trained", "weights.npz"))
    image = decode.decode_and_resize(
        os.path.join(GOLDEN, "trained", "fixture_000.png"), 160, 160
    )[None]
    kw = dict(num_classes=3, input_size=(160, 160), device="cpu")
    want = Predictor("n", sd, **kw).predict_batch(image)
    folded = fold_batchnorm(sd)
    got = Predictor("n", folded, **kw).predict_batch(image)
    assert want["valid"].any()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_predictor_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    sd = load_npz(os.path.join(GOLDEN, "trained", "weights.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor("n", sd, num_classes=3, input_size=(160, 160))


def test_letterbox_predict_image_and_coco_export(tmp_path):
    pred = _predictor("n", "trained", letterbox=True)
    image = decode.decode_image(os.path.join(GOLDEN, "trained", "fixture_000.png"))
    dets = pred.predict_image(image)
    h, w = image.shape[:2]
    assert dets and all(d["class_id"] in (0, 1, 2) for d in dets)
    for d in dets:
        x1, y1, x2, y2 = d["box_xyxy"]
        assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
    drawn = draw_detections(image, dets)
    assert drawn.shape == image.shape and not np.array_equal(drawn, image)
    out = tmp_path / "coco.json"
    pred.export_coco_json({"dir/000123.png": dets}, str(out))
    records = json.loads(out.read_text())
    assert len(records) == len(dets) and records[0]["image_id"] == 123
    x1, y1, x2, y2 = dets[0]["box_xyxy"]
    assert records[0]["bbox"] == [x1, y1, round(x2 - x1, 2), round(y2 - y1, 2)]


def test_find_images(tmp_path):
    with pytest.raises(FileNotFoundError):
        find_images(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        find_images(str(tmp_path))
    for name in ("b.png", "a.JPG", "c.txt"):
        (tmp_path / name).write_bytes(b"")
    assert [os.path.basename(p) for p in find_images(str(tmp_path))] == ["a.JPG", "b.png"]


def test_normalize_matches_jax():
    imgs = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = augment.device_normalize_images(torch.from_numpy(imgs), torch.float32).numpy()
    want = np.asarray(jax_augment.device_normalize_images(jnp.asarray(imgs), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jax_augment.normalize_imagenet(imgs), rtol=0, atol=1e-5)
    x = torch.ones(1, 2, 2, 3)
    assert augment.device_normalize_images(x, torch.bfloat16) is x
    np.testing.assert_array_equal(augment.IMAGENET_MEAN, jax_augment.IMAGENET_MEAN)
    np.testing.assert_array_equal(augment.IMAGENET_STD, jax_augment.IMAGENET_STD)


def test_host_copies_match_jax():
    path = os.path.join(GOLDEN, "trained", "fixture_000.png")
    np.testing.assert_array_equal(decode.decode_image(path), jax_decode.decode_image(path))
    np.testing.assert_array_equal(
        decode.decode_and_resize(path, 160, 128), jax_decode.decode_and_resize(path, 160, 128)
    )
    img = decode.decode_image(path)
    boxes = np.asarray([[10, 20, 100, 120]], np.float32)
    got = augment.letterbox(img, boxes, 160, 160)
    want = jax_augment.letterbox(img, boxes, 160, 160)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
