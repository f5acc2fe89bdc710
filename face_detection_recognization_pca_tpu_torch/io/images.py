"""Image file I/O + eigenface/mean-face JPEG dumps (the port's own copy
of the JAX package's ``io/images.py``).

Host-side, with OpenCV imported inside the functions that read or write
a file, so the module imports where OpenCV is absent.  The eigenface
dump reproduces the reference's min-max normalization to uint8 and
file naming (``train-v4.py:148-179``, ``useless/train.py:194-258``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def imread_gray(path: str) -> Optional[np.ndarray]:
    """Grayscale read, cv2-compatible (IMREAD_GRAYSCALE)."""
    import cv2

    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def imread_bgr(path: str) -> Optional[np.ndarray]:
    import cv2

    return cv2.imread(path)


def imwrite(path: str, img: np.ndarray) -> bool:
    import cv2

    return cv2.imwrite(path, img)


def minmax_to_u8(x: np.ndarray) -> np.ndarray:
    """Reference normalization for eigenface visualization
    (train-v4.py:163-170): (x - min) / (max - min) * 255 as uint8."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = x.min(), x.max()
    if hi > lo:
        x = (x - lo) / (hi - lo) * 255.0
    else:
        x = np.zeros_like(x)
    return x.astype(np.uint8)


def save_eigenface_images(
    components: np.ndarray,
    mean_face: np.ndarray,
    face_shape: Tuple[int, int],
    output_dir: str,
    prefix: str = "",
    top_k: int = 10,
) -> List[str]:
    """Dump mean face + top-k eigenfaces as min-max-normalized JPEGs.

    File naming parity: ``{prefix}mean_face.jpg`` and
    ``{prefix}eigenface_{i+1:02d}.jpg`` (reference ``train-v4.py:171-177``,
    multi-person variant ``train-v5.py:404-418``).
    """
    os.makedirs(output_dir, exist_ok=True)
    written = []
    h, w = face_shape
    mean_img = minmax_to_u8(np.asarray(mean_face).reshape(h, w))
    mean_path = os.path.join(output_dir, f"{prefix}mean_face.jpg")
    imwrite(mean_path, mean_img)
    written.append(mean_path)
    k = min(top_k, components.shape[0])
    for i in range(k):
        face = minmax_to_u8(np.asarray(components[i]).reshape(h, w))
        p = os.path.join(output_dir, f"{prefix}eigenface_{i + 1:02d}.jpg")
        imwrite(p, face)
        written.append(p)
    return written
