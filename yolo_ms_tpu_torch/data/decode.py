"""Image decode with optional native C++ fast path.

Copy of ``yolo_ms_tpu/data/decode.py`` (framework-free; the port keeps its
own copy because importing the JAX package pulls in jax and flax).

The reference decodes with PIL inside DataLoader worker subprocesses
(dataset.py:154). Here decode goes through the libjpeg/libpng-backed C++
loader in native/ when built (see native/README.md), falling back to
cv2/PIL. The native path also performs fused resize so only the target-size
pixels cross into Python.
"""

from __future__ import annotations

import numpy as np

from yolo_ms_tpu_torch.data import native_loader


def _get_native():
    return native_loader if native_loader.available() else None


def decode_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 HWC."""
    native = _get_native()
    if native is not None:
        img = native.decode(path)
        if img is not None:
            return img
    return _decode_python(path)


def decode_and_resize(path: str, height: int, width: int) -> np.ndarray:
    """Decode + bilinear resize in one step (native fast path when built)."""
    native = _get_native()
    if native is not None:
        img = native.decode_resize(path, height, width)
        if img is not None:
            return img
    import cv2

    img = _decode_python(path)
    return cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)


def _decode_python(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
