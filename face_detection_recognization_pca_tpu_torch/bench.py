"""Self-checking tracker workload (port of ``bench._tracker_assets``).

BASELINE config 5: S video streams of 1080p frames, each with a 96x96
planted face that drifts by up to 2 px per frame batch, tracked by
:class:`..parallel.multistream.MultiStreamRecognizer` with a 192x192
search window.  Gallery row 0 is the exact planted face, so a correct
step reports every planted position and gallery row 0
(:func:`planted_exact`).
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

import numpy as np
import torch

SIZES = {"1080p": (1080, 1920), "720p": (720, 1280), "544p": (544, 960)}
WIN = 192  # search window side (guided scanner: 1.5-2x face box)
TPL = 96  # template / face box side
GALLERY_N = 256
N_COMPONENTS = 64


def tracker_assets(
    streams: int,
    size: Tuple[int, int],
    batches: int,
    seed: int,
    device: torch.device,
):
    """``(frames, gallery_images, face, plants)``.

    ``frames``: (batches, S, H, W) float32 on ``device``, noise
    ``110 + 25 N(0, 1)`` from a ``torch.Generator`` on the device seeded
    with ``seed``, with the face planted at ``plants``.  ``gallery_images``:
    (256, 96*96) float32 on ``device``, row 0 the exact face, the rest
    shifted and noised copies.  ``face`` (96, 96) and ``plants``
    (batches, S, 2) of (y, x) are numpy.  The face, the plants and the
    gallery come from ``np.random.default_rng(seed)`` in the JAX
    package's order, so they equal its ``_tracker_assets``'s."""
    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:TPL, 0:TPL].astype(np.float32) / TPL
    face = (
        140
        + 60 * np.sin(6.28 * yy * 2.1)
        + 40 * np.cos(6.28 * xx * 1.7)
        + rng.normal(0, 8, (TPL, TPL))
    ).astype(np.float32)

    # Random interior start per stream, +-2 px drift per batch (inside the
    # tracker's re-centred window every step).
    margin = WIN
    pos = np.stack(
        [
            rng.integers(margin, h - margin, streams),
            rng.integers(margin, w - margin, streams),
        ],
        axis=1,
    ).astype(np.int32)
    plants = np.zeros((batches, streams, 2), np.int32)
    for f in range(batches):
        plants[f] = pos
        pos = pos + rng.integers(-2, 3, (streams, 2)).astype(np.int32)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frames = torch.empty((batches * streams, h, w), dtype=torch.float32, device=device)
    frames.normal_(110.0, 25.0, generator=gen)
    flat_plants = torch.from_numpy(plants.reshape(-1, 2)).to(device)
    ar = torch.arange(TPL, device=device)
    rows = (flat_plants[:, 0, None] + ar)[:, :, None]
    cols = (flat_plants[:, 1, None] + ar)[:, None, :]
    index = torch.arange(batches * streams, device=device)[:, None, None]
    frames[index, rows, cols] = torch.from_numpy(face).to(device)
    frames = frames.reshape(batches, streams, h, w)

    gal_imgs = np.stack(
        [
            np.roll(face, (rng.integers(-2, 3), rng.integers(-2, 3)), (0, 1)).reshape(-1)
            + rng.normal(0, 4, TPL * TPL)
            for _ in range(GALLERY_N)
        ]
    ).astype(np.float32)
    gal_imgs[0] = face.reshape(-1)
    return frames, torch.from_numpy(gal_imgs).to(device), face, plants


def planted_exact(
    outs: Union[Mapping[str, torch.Tensor], Sequence[Mapping[str, torch.Tensor]]],
    plants: np.ndarray,
) -> bool:
    """True when every reported (x, y) is the planted position and every
    gallery row is 0.  ``outs`` is one ``process_window`` result (leading
    T axis) or a sequence of T ``process_batch`` results; ``plants`` is
    (T, S, 2) of (y, x)."""
    if not isinstance(outs, Mapping):
        outs = {key: torch.stack([o[key] for o in outs]) for key in ("x", "y", "gallery_row")}
    x, y, rows = (outs[key].cpu().numpy() for key in ("x", "y", "gallery_row"))
    if x.shape != plants.shape[:2]:
        return False
    return bool(
        np.array_equal(x, plants[..., 1])
        and np.array_equal(y, plants[..., 0])
        and np.all(rows == 0)
    )
