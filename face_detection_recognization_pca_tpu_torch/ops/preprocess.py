"""Face-crop preprocessing: gray -> resize -> flatten (port of
``ops/preprocess.py``, float path).

The exact uint8 path (``exact=True``) needs the fixed-point resize
``resize_bilinear_u8_exact``, which is not ported yet (ROADMAP queue 1,
item 2); it raises rather than fall back to the float path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from face_detection_recognization_pca_tpu_torch.ops.color import bgr_to_gray
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear


def preprocess_crops(
    crops: torch.Tensor,
    face_size: Tuple[int, int] = (64, 64),
    exact: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crops ``(B, H, W)`` gray or ``(B, H, W, 3)`` BGR -> face vectors
    ``(B, w * h)``; ``face_size`` is ``(width, height)``, cv2's order, and
    the flatten is row-major like ``np.ndarray.flatten``."""
    if exact:
        raise NotImplementedError(
            "exact=True needs resize_bilinear_u8_exact, not ported yet "
            "(ROADMAP queue 1, item 2)"
        )
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
