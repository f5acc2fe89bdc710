"""Port parity, bit for bit: the fixed-point uint8 resize and the exact
preprocessing path against the JAX package (and against ``cv2.resize``
itself where OpenCV imports), on the shapes ``tests/test_ops_parity.py``
sweeps: up, down, mixed, pure-horizontal, border-heavy and batched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.ops import preprocess as jpre
from face_detection_recognization_pca_tpu.ops import resize as jresize
from face_detection_recognization_pca_tpu_torch.ops import preprocess as tpre
from face_detection_recognization_pca_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)

# (source shape, dsize as (width, height))
CASES = {
    "down_to_face": ((200, 180), (64, 64)),
    "down_v1_face": ((151, 149), (100, 100)),
    "up_small_crop": ((30, 26), (64, 64)),
    "up_odd": ((17, 23), (91, 57)),
    "mixed_up_w_down_h": ((90, 40), (100, 33)),
    "mixed_down_w_up_h": ((21, 120), (48, 80)),
    "template_0p8": ((96, 96), (77, 77)),
    "pure_horizontal_down": ((48, 90), (33, 48)),
    "pure_horizontal_up": ((20, 11), (57, 20)),
    "identity": ((96, 96), (96, 96)),
    "border_heavy_tiny_up": ((3, 4), (29, 31)),
    "border_heavy_two_rows": ((2, 2), (64, 64)),
    "one_pixel": ((1, 1), (5, 7)),
    "batched": ((5, 40, 36), (64, 64)),
    "batched_two_dims": ((2, 3, 31, 17), (8, 12)),
    "batched_pure_horizontal": ((4, 24, 50), (32, 24)),
}


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    # Saturated and empty corners: the clamp and the border weights.
    img[..., 0, 0], img[..., -1, -1] = 255, 0
    return img


@pytest.mark.parametrize("name", CASES)
def test_resize_u8_exact_equals_jax_and_cv2(name):
    shape, dsize = CASES[name]
    img = _image(shape, sorted(CASES).index(name))
    got = tresize.resize_bilinear_u8_exact(torch.from_numpy(img), dsize)
    assert got.dtype == torch.uint8
    assert got.shape == (*shape[:-2], dsize[1], dsize[0])
    ref = np.asarray(jresize.resize_bilinear_u8_exact(jnp.asarray(img), dsize))
    np.testing.assert_array_equal(got.numpy(), ref)
    cv2 = pytest.importorskip("cv2")
    flat = img.reshape(-1, *shape[-2:])
    want = np.stack([cv2.resize(one, dsize, interpolation=cv2.INTER_LINEAR) for one in flat])
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def test_fixed_point_coeffs_equal_jax():
    for src, dst in [(200, 64), (30, 64), (96, 77), (2, 64), (1, 5), (50, 50)]:
        for a, b in zip(tresize._fixed_point_coeffs(src, dst),
                        jresize._fixed_point_coeffs(src, dst)):
            np.testing.assert_array_equal(a, b)
        s0, s1, w0, w1 = tresize._fixed_point_coeffs(src, dst)
        assert s0.min() >= 0 and s1.max() <= src - 1
        assert w0.dtype == w1.dtype == np.int32


@pytest.mark.parametrize("shape", [(4, 30, 26), (4, 30, 26, 3), (3, 80, 71), (3, 80, 71, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_preprocess_crops_exact_equal_jax(shape, dtype):
    """Gray and BGR uint8 crops through ``exact=True``: equal bytes."""
    crops = _image(shape, len(shape))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = np.asarray(jpre.preprocess_crops(jnp.asarray(crops), (20, 24), exact=True,
                                           dtype=jdtype))
    got = tpre.preprocess_crops(torch.from_numpy(crops), (20, 24), exact=True, dtype=dtype)
    assert got.dtype == dtype and got.shape == ref.shape == (shape[0], 480)
    assert got.numpy().tobytes() == ref.tobytes()
    # Whole uint8 steps, near the float path: the gray conversion and the
    # resize each round once, by up to half a step and a little more.
    assert torch.equal(got, got.round())
    loose = tpre.preprocess_crops(torch.from_numpy(crops), (20, 24), dtype=dtype)
    assert float((got - loose).abs().max()) <= 1.5
    one = tpre.preprocess_crop(torch.from_numpy(crops[1]), (20, 24), exact=True, dtype=dtype)
    assert torch.equal(one, got[1])
