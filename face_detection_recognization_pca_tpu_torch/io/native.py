"""ctypes bindings for the native framestage library.

Thread-pool JPEG batch decoding and a background video ring buffer
(see ``native/framestage/framestage.cpp``).  Falls back to the pure
cv2/Python paths when the shared library has not been built; callers
can treat :func:`available` as a capability flag.

Build with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB = None
_SEARCH = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libframestage.so"),
    "libframestage.so",
)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for path in _SEARCH:
        try:
            lib = ctypes.CDLL(os.path.abspath(path) if os.sep in path else path)
        except OSError:
            continue
        lib.fs_decode_jpegs.restype = ctypes.c_int
        lib.fs_decode_jpegs.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.vr_open.restype = ctypes.c_void_p
        lib.vr_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.vr_meta.restype = ctypes.c_int
        lib.vr_meta.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vr_next.restype = ctypes.c_int
        lib.vr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
        lib.vr_close.restype = None
        lib.vr_close.argtypes = [ctypes.c_void_p]
        try:  # present in .so builds that include the grouping service
            lib.gr_group.restype = ctypes.c_int
            lib.gr_group.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
        except AttributeError:
            pass
        _LIB = lib
        return lib
    _LIB = False
    return False


def available() -> bool:
    return bool(_load())


def decode_jpegs_batch(
    paths: Sequence[str],
    gray: bool = True,
    size_wh: Optional[Tuple[int, int]] = None,
    num_threads: int = 0,
    return_dims: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Decode a batch of images in parallel native threads.

    Args:
      paths: image file paths.
      gray: grayscale (1 channel) vs BGR (3 channels).
      size_wh: (width, height) resize applied in C++ (cv::INTER_LINEAR,
        identical values to the cv2 wheel); required (fixed slot size).
      return_dims: also return each image's ORIGINAL (pre-resize)
        (h, w) -- the C++ side always records them; template banks use
        them to keep reference native-size scale semantics.

    Returns:
      (images (n, h, w[, 3]) uint8, ok (n,) bool) and, with
      ``return_dims``, original dims (n, 2) int32 as (h, w) rows.
    """
    lib = _load()
    if not lib:
        raise RuntimeError("libframestage.so not built (make -C native)")
    if size_wh is None:
        raise ValueError("size_wh is required for batch decode")
    w, h = size_wh
    n = len(paths)
    ch = 1 if gray else 3
    out = np.empty((n, h, w, ch) if ch > 1 else (n, h, w), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.int32)
    dims = np.zeros(2 * n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.fs_decode_jpegs(
        arr,
        n,
        1 if gray else 0,
        h,
        w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    if return_dims:
        return out, ok.astype(bool), dims.reshape(n, 2)
    return out, ok.astype(bool)


def group_rectangles_native(rects, group_threshold: int, eps: float):
    """Native ``groupRectangles`` clustering (detect/haar.py host half).

    Returns the merged ``[(x, y, w, h), ...]`` list, or ``None`` when
    the shared library (or its ``gr_group`` symbol) is unavailable --
    the caller falls back to the pure-Python implementation, which is
    semantically identical (tested element-exact in
    tests/test_native.py)."""
    lib = _load()
    if not lib or not hasattr(lib, "gr_group"):
        return None
    arr = np.ascontiguousarray(rects, dtype=np.float64)
    n = arr.shape[0]
    out = np.empty((max(n, 1), 4), dtype=np.int32)
    m = lib.gr_group(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        int(group_threshold),
        float(eps),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n,
    )
    return [tuple(int(v) for v in row) for row in out[:m]]


class NativeVideoReader:
    """Ring-buffered video reader: a C++ thread decodes ahead."""

    def __init__(self, path: str, ring: int = 4, gray: bool = False):
        lib = _load()
        if not lib:
            raise RuntimeError("libframestage.so not built (make -C native)")
        self._lib = lib
        self._h = lib.vr_open(path.encode(), ring, 1 if gray else 0)
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        w = ctypes.c_int()
        ht = ctypes.c_int()
        fps = ctypes.c_double()
        count = ctypes.c_int()
        lib.vr_meta(self._h, w, ht, fps, count)
        self.width, self.height = w.value, ht.value
        self.fps, self.frame_count = fps.value, count.value
        self._gray = gray
        self._shape = (
            (self.height, self.width) if gray else (self.height, self.width, 3)
        )

    def frames(self):
        buf = np.empty(self._shape, dtype=np.uint8)
        while True:
            r = self._lib.vr_next(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            )
            if not r:
                return
            yield buf.copy()

    def close(self):
        if self._h:
            self._lib.vr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
