"""Seeded inputs of the benchmark's cells, made from ``--seed`` alone.

The recipes of the faces, the Haar scenes and the noise frames are copies
of the port's own bench generators (``face_detection_recognization_pca_tpu_torch/
bench.py``: ``_planted_face``, ``_noise_frames``, ``tracker_assets``,
``haar_face``, ``haar_plants``, ``haar_bgr_frames``), kept here so that a
change to the program cannot change what the benchmark feeds it.  Every
function takes its sizes from a configuration file and a traffic file and
draws in a fixed order from ``numpy.random.default_rng(seed)``; frames
that live on the card are drawn there by a ``torch.Generator`` seeded with
the same seed.  The same seed gives the same inputs.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

SEED_SPACE = 1 << 63


def rng_for(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % SEED_SPACE)


def planted_face(rng: np.random.Generator, tpl: int) -> np.ndarray:
    """A structured (tpl, tpl) float32 "face": smooth stripes plus N(0, 8)."""
    yy, xx = np.mgrid[0:tpl, 0:tpl].astype(np.float32) / tpl
    return (
        140
        + 60 * np.sin(6.28 * yy * 2.1)
        + 40 * np.cos(6.28 * xx * 1.7)
        + rng.normal(0, 8, (tpl, tpl))
    ).astype(np.float32)


def dct_modes(side: int, per_axis: int) -> np.ndarray:
    """``(per_axis**2, side*side)`` orthonormal low-frequency 2-D cosines."""
    x = (np.arange(side) + 0.5) / side
    rows = []
    for u in range(per_axis):
        for v in range(per_axis):
            m = np.outer(np.cos(np.pi * u * x), np.cos(np.pi * v * x))
            rows.append(m.reshape(-1) / np.linalg.norm(m))
    return np.stack(rows)


def mode_gallery(rng: np.random.Generator, face: np.ndarray, n: int, per_axis: int,
                 mode_sd: float, pixel_sd: float) -> np.ndarray:
    """``(n, side*side)`` float32 enrolment images: ``face`` plus
    ``per_axis**2`` smooth modes with N(0, mode_sd) weights per image plus
    N(0, pixel_sd) per pixel.  The modes' variance stands well above the
    pixel noise's, so the top components' span is fixed by the data and
    not by rounding (see ``PERF.md``)."""
    modes = dct_modes(face.shape[0], per_axis)
    weights = mode_sd * rng.standard_normal((n, modes.shape[0]))
    pixels = pixel_sd * rng.standard_normal((n, face.size))
    return (face.reshape(1, -1) + weights @ modes + pixels).astype(np.float32)


def back_and_forth(rng: np.random.Generator, streams: int, steps: int, step_px: Tuple[int, int],
                   lo: Tuple[int, int], hi: Tuple[int, int]) -> np.ndarray:
    """``(steps, streams, 2)`` int32 (y, x): a start drawn in ``[lo, hi)``
    per stream, then a move of ``step_px[0]..step_px[1]`` px per axis, of a
    random sign, repeated for half the steps and undone for the other
    half, so the walk ends where it began and a pool of ``steps`` frames
    can be cycled for ever.  The face goes ``steps / 2`` moves away from
    its start: far enough that a window left where it began loses it."""
    if steps % 2:
        raise ValueError("a walk out and back needs an even number of steps")
    start = np.stack([rng.integers(lo[0], hi[0], streams),
                      rng.integers(lo[1], hi[1], streams)], axis=1)
    move = rng.integers(step_px[0], step_px[1] + 1, (streams, 2)) * rng.choice([-1, 1], (streams, 2))
    out = np.minimum(np.arange(steps), steps - np.arange(steps))
    return (start[None] + out[:, None, None] * move[None]).astype(np.int32)


def noise_frames(shape: Tuple[int, ...], seed: int, device: torch.device,
                 mean: float, sd: float) -> torch.Tensor:
    """float32 frames of ``mean + sd * N(0, 1)`` drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_SPACE)
    frames = torch.empty(shape, dtype=torch.float32, device=device)
    frames.normal_(mean, sd, generator=gen)
    return frames


def plant_noisy(frames: torch.Tensor, face: np.ndarray, plants: np.ndarray, mean: float,
                sd: float, face_sd: float) -> None:
    """Write ``face`` into frame i of ``frames`` (n, H, W) at ``plants[i]``
    = (y, x), keeping the frame's own noise there scaled from ``sd`` down to
    ``face_sd``: the face as a camera sees it, never the template's exact
    pixels."""
    tpl = face.shape[0]
    device = frames.device
    plants = torch.from_numpy(np.ascontiguousarray(plants.reshape(-1, 2))).to(device)
    ar = torch.arange(tpl, device=device)
    rows = (plants[:, 0, None] + ar)[:, :, None]
    cols = (plants[:, 1, None] + ar)[:, None, :]
    index = torch.arange(frames.shape[0], device=device)[:, None, None]
    noise = frames[index, rows, cols]
    frames[index, rows, cols] = torch.from_numpy(face).to(device) + (noise - mean) * (face_sd / sd)


# The synthetic face of :func:`haar_face` on the cascade's 24 x 24 base grid
# (pixel centres at 0..23): a grey level plus Gaussian blobs
# ``amp * exp(-((y - cy)^2 / 2 sy^2 + (x - cx)^2 / 2 sx^2))``, the paired
# ones mirrored about x = 11.5 at ``11.5 -+ dx``; fitted so that the
# frontal-face cascade accepts it at 0.86-1.21 of the base size.
_HAAR_FACE_LEVEL = 80.9
_HAAR_FACE_BLOBS = (  # (amp, cy, cx, sy, sx)
    (134.2, 11.8, 11.6, 10.0, 7.5),  # head
    (26.6, 11.1, 11.2, 4.5, 0.9),  # nose bridge
    (-62.5, 15.4, 11.3, 1.4, 3.5),  # mouth
)
_HAAR_FACE_PAIRS = (  # (amp, cy, dx, sy, sx)
    (-79.8, 9.4, 2.2, 1.3, 1.8),  # eyes
    (9.7, 4.9, 2.7, 1.5, 2.9),  # brows
    (40.6, 14.4, 7.1, 3.4, 1.7),  # cheeks
)
HAAR_FACE_MARGIN = 0.125  # of the side, rendered around the face on each side
HAAR_TEXTURE_LEVELS = 5.0  # grey levels: the amplitude of each of a person's three waves


@functools.lru_cache(maxsize=1024)
def haar_face(side: int, person: int = 0) -> np.ndarray:
    """A uint8 frontal face of nominal ``side`` px that the frontal-face
    cascade accepts, in a patch of ``round(1.25 * side)`` px.  ``person``
    other than 0 adds a smooth texture of a few grey levels (three waves
    from ``np.random.default_rng(person)``) that tells persons apart.  The
    blobs and waves are separable, so each is an outer product of two
    rows; the patch is read-only, as the cache shares it."""
    patch = int(round(side * (1 + 2 * HAAR_FACE_MARGIN)))
    c = (np.arange(patch) + 0.5 - (patch - side) / 2.0) * (24.0 / side) - 0.5

    def bell(centre, sigma):
        return np.exp(-((c - centre) ** 2) / (2 * sigma * sigma))

    img = np.full((patch, patch), _HAAR_FACE_LEVEL)
    for amp, cy, cx, sy, sx in _HAAR_FACE_BLOBS:
        img += amp * np.outer(bell(cy, sy), bell(cx, sx))
    for amp, cy, dx, sy, sx in _HAAR_FACE_PAIRS:
        img += amp * np.outer(bell(cy, sy), bell(11.5 - dx, sx) + bell(11.5 + dx, sx))
    if person:
        rng = np.random.default_rng(person)
        for _ in range(3):
            fy, fx = rng.uniform(-0.35, 0.35, 2)
            phase = fy * c + rng.uniform(0, 6.28)
            img += HAAR_TEXTURE_LEVELS * (np.outer(np.cos(phase), np.cos(fx * c))
                                          - np.outer(np.sin(phase), np.sin(fx * c)))
    face = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    face.setflags(write=False)
    return face


def haar_scenes(rng: np.random.Generator, n: int, size: Tuple[int, int], persons: Sequence[int],
                faces_per_frame: int, sides: Tuple[int, int], noise: Tuple[float, float]):
    """``(n, H, W, 3)`` uint8 BGR frames (B = G = R) of rounded grey noise,
    each holding ``faces_per_frame`` :func:`haar_face` patches, face j of
    frame i of person ``persons[(i * faces_per_frame + j) % len(persons)]``.
    One face lies anywhere at least 8 px inside the frame; more faces each
    lie in their own cell of a near-square grid."""
    h, w = size
    cols = int(np.ceil(np.sqrt(faces_per_frame)))
    rows_ = int(np.ceil(faces_per_frame / cols))
    ch, cw = h // rows_, w // cols
    gray = np.clip(np.rint(rng.normal(noise[0], noise[1], (n, h, w))), 0, 255).astype(np.uint8)
    for i in range(n):
        for j in range(faces_per_frame):
            y0, x0 = (j // cols) * ch, (j % cols) * cw
            side = int(rng.integers(sides[0], sides[1] + 1))
            patch = int(round(side * (1 + 2 * HAAR_FACE_MARGIN)))
            if patch + 16 > min(ch, cw):
                raise ValueError(f"a face of side {side} does not fit a {ch} x {cw} cell")
            y = y0 + int(rng.integers(8, ch - patch - 8 + 1))
            x = x0 + int(rng.integers(8, cw - patch - 8 + 1))
            person = int(persons[(i * faces_per_frame + j) % len(persons)])
            gray[i, y:y + patch, x:x + patch] = haar_face(side, person)
    return np.repeat(gray[..., None], 3, axis=3)


def person_crops(rng: np.random.Generator, person: int, count: int, sides: Tuple[int, int],
                 jitter: float, pixel_sd: float) -> List[np.ndarray]:
    """``count`` uint8 BGR crops of :func:`haar_face` renderings of
    ``person`` as a detector cuts them: a side drawn from ``sides``, the box
    about the nominal face shifted by up to ``jitter`` of the side, the
    sensor's N(0, pixel_sd) on top."""
    crops = []
    for _ in range(count):
        side = int(rng.integers(sides[0], sides[1] + 1))
        patch = haar_face(side, person).astype(np.float64)
        m = (patch.shape[0] - side) // 2
        reach = int(jitter * side)
        dy, dx = rng.integers(-reach, reach + 1, 2)
        crop = patch[m + dy:m + dy + side, m + dx:m + dx + side]
        crop = crop + pixel_sd * rng.standard_normal(crop.shape)
        crop = np.clip(np.rint(crop), 0, 255).astype(np.uint8)
        crops.append(np.repeat(crop[..., None], 3, axis=2))
    return crops
