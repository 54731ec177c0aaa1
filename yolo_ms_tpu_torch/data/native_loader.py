"""ctypes binding for the native C++ decode/resize library (native/loader.cpp).

The calls of ``yolo_ms_tpu/data/native_loader.py``, copied (single images
for serving, whole batches for the eval loader); both packages share the
one library at ``native/libyolodata.so``.

Optional fast path: `available()` is False (and everything falls back to
cv2/PIL in data/decode.py) unless native/libyolodata.so has been built via
native/build.sh.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

_SO_CANDIDATES = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libyolodata.so"),
    os.path.join(os.path.dirname(__file__), "libyolodata.so"),
)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for cand in _SO_CANDIDATES:
        path = os.path.abspath(cand)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.yd_decode_image.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int,
                ]
                lib.yd_decode_image.restype = ctypes.c_int
                lib.yd_decode_resize.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_int,
                ]
                lib.yd_decode_resize.restype = ctypes.c_int
                lib.yd_decode_resize_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                ]
                lib.yd_decode_resize_batch.restype = ctypes.c_int
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


MAX_IMAGE_BYTES = 64 * 1024 * 1024  # 64MP RGB cap


def decode(path: str) -> np.ndarray | None:
    """Decode to original-size RGB uint8 HWC, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(MAX_IMAGE_BYTES, np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.yd_decode_image(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(w),
        ctypes.byref(h),
        MAX_IMAGE_BYTES,
    )
    if rc != 0:
        return None
    n = w.value * h.value * 3
    return buf[:n].reshape(h.value, w.value, 3).copy()


def decode_resize(path: str, out_h: int, out_w: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.yd_decode_resize(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h,
        out_w,
    )
    if rc != 0:
        return None
    return out


def decode_resize_batch(
    paths: list[str], out_h: int, out_w: int, num_threads: int = 4
) -> np.ndarray | None:
    """Decode a whole batch in one native call -> [N, out_h, out_w, 3] uint8.
    Failed images come back zero-filled (matching the loader's dummy-sample
    tolerance, reference dataset.py:185-207)."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.yd_decode_resize_batch(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h,
        out_w,
        num_threads,
    )
    return out
