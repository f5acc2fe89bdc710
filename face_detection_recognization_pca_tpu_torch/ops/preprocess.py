"""Face-crop preprocessing: gray -> resize -> flatten (port of
``ops/preprocess.py``).

Two paths, as in the JAX package: the float one (matmul resize, within
one uint8 step of OpenCV) and, with ``exact=True``, OpenCV's own 8-bit
fixed-point arithmetic bit for bit (``bgr_to_gray_exact`` and
``resize_bilinear_u8_exact``), which the artifact-compatible flows use.
"""

from __future__ import annotations

from typing import Tuple

import torch

from face_detection_recognization_pca_tpu_torch.ops.color import (
    bgr_to_gray,
    bgr_to_gray_exact,
)
from face_detection_recognization_pca_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_bilinear_u8_exact,
)


def preprocess_crops(
    crops: torch.Tensor,
    face_size: Tuple[int, int] = (64, 64),
    exact: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crops ``(B, H, W)`` gray or ``(B, H, W, 3)`` BGR -> face vectors
    ``(B, w * h)``; ``face_size`` is ``(width, height)``, cv2's order, and
    the flatten is row-major like ``np.ndarray.flatten``.  With ``exact``
    the crops are taken as uint8 (a float crop is truncated, as a cast
    does) and every pixel equals ``cv2.cvtColor`` + ``cv2.resize``'s."""
    if exact:
        gray = bgr_to_gray_exact(crops) if crops.dim() == 4 else crops
        resized = resize_bilinear_u8_exact(gray.to(torch.uint8), face_size)
    else:
        gray = bgr_to_gray(crops, dtype) if crops.dim() == 4 else crops
        resized = resize_bilinear(gray, face_size, dtype=dtype)
    return resized.reshape(resized.shape[0], -1).to(dtype)


def preprocess_crop(
    crop: torch.Tensor,
    face_size: Tuple[int, int] = (64, 64),
    exact: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One ``(H, W)`` gray or ``(H, W, 3)`` BGR crop -> ``(w * h,)``."""
    return preprocess_crops(crop[None], face_size, exact=exact, dtype=dtype)[0]
