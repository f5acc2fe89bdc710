"""Shared by the Haar tests of the port: an independent float64 numpy
cascade, seeded frames that hold synthetic faces, and a detector that
hands one package's apps the other package's detections.  Imports no JAX,
so the GPU tests can use it where JAX is absent."""

import numpy as np

from face_detection_recognization_pca_tpu_torch import bench


def numpy_cascade_margins(gray, cascade, step=2):
    """``(ny, nx)`` float64: for every window of one pyramid level, the
    smallest ``stage sum - stage threshold`` over all stages.  Written from
    the OpenCV algorithm (window normalization
    ``nf = sqrt(area*sqsum - sum^2)``, stump test ``rectsum < t * nf``,
    per-stage sum thresholds), every window through every stage."""
    f = np.asarray(gray, dtype=np.float64)
    h, w = f.shape
    wh, ww = cascade.window_size
    integral = np.zeros((h + 1, w + 1))
    integral[1:, 1:] = f.cumsum(0).cumsum(1)
    sqintegral = np.zeros((h + 1, w + 1))
    sqintegral[1:, 1:] = (f * f).cumsum(0).cumsum(1)
    ny = (h - wh) // step + 1
    nx = (w - ww) // step + 1

    def rect_sum(ii, x, y, rw, rh):
        ys = np.arange(ny) * step
        xs = np.arange(nx) * step
        Y, X = np.meshgrid(ys, xs, indexing="ij")
        return (
            ii[Y + y + rh, X + x + rw]
            - ii[Y + y + rh, X + x]
            - ii[Y + y, X + x + rw]
            + ii[Y + y, X + x]
        )

    area = (wh - 2) * (ww - 2)
    s1 = rect_sum(integral, 1, 1, ww - 2, wh - 2)
    s2 = rect_sum(sqintegral, 1, 1, ww - 2, wh - 2)
    nf2 = area * s2 - s1 * s1
    nf = np.where(nf2 > 0, np.sqrt(np.maximum(nf2, 0)), 1.0)

    margin = np.full((ny, nx), np.inf)
    for si in range(cascade.n_stages):
        stage_sum = np.zeros((ny, nx))
        for s in range(cascade.stage_offsets[si], cascade.stage_offsets[si + 1]):
            val = np.zeros((ny, nx))
            for (x, y, rw, rh, wt) in cascade.rects[cascade.stump_feature[s]]:
                if wt == 0.0:
                    continue
                val += wt * rect_sum(integral, int(x), int(y), int(rw), int(rh))
            stage_sum += np.where(
                val < cascade.stump_threshold[s] * nf, cascade.leaf0[s], cascade.leaf1[s]
            )
        margin = np.minimum(margin, stage_sum - np.float64(cascade.stage_thresholds[si]))
    return margin


def numpy_cascade_accepts(gray, cascade, step=2):
    """The ``(x, y)`` of the windows of one level that pass every stage."""
    ys, xs = np.nonzero(numpy_cascade_margins(gray, cascade, step) >= 0)
    return {(int(x) * step, int(y) * step) for y, x in zip(ys, xs)}


def scene(size, plants, noise, rng):
    """A uint8 ``size`` gray frame of rounded ``noise`` = (mean, sd) normal
    noise with ``bench.haar_face(side, person)`` patches written at
    ``plants`` = [(y, x, side, person)], cut at the frame's border."""
    h, w = size
    f = noise[0] + noise[1] * rng.standard_normal((h, w))
    for (y, x, side, person) in plants:
        patch = bench.haar_face(side, person)
        ph, pw = min(patch.shape[0], h - y), min(patch.shape[1], w - x)
        f[y:y + ph, x:x + pw] = patch[:ph, :pw]
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def frames180():
    """Four 180 x 240 frames: one face; two faces of different sides (the
    second another person's); noise only; one face cut by the border."""
    rng = np.random.default_rng(11)
    return np.stack([
        scene((180, 240), [(30, 60, 72, 0)], (88, 6), rng),
        scene((180, 240), [(10, 10, 48, 0), (60, 110, 88, 1)], (110, 25), rng),
        scene((180, 240), [], (88, 6), rng),
        scene((180, 240), [(100, 150, 80, 0)], (110, 25), rng),
    ])


class ReplayDetector:
    """Hands an app of either package the detections of ``detector`` (the
    port's, on the CPU): the detector interface on host arrays, whatever
    array type the app passes in."""

    def __init__(self, detector):
        self.detector = detector

    def detect_multi_scale(self, gray, *args, **kwargs):
        return self.detector.detect_multi_scale(np.array(gray), *args, **kwargs)

    def detect_multi_scale_batch(self, grays, *args, **kwargs):
        return self.detector.detect_multi_scale_batch(np.array(grays), *args, **kwargs)

    def detect_device(self, grays, *args, **kwargs):
        return self.detector.detect_device(np.array(grays), *args, **kwargs)

    def detect_finish(self, handle):
        return self.detector.detect_finish(handle)


VIDEO_PLANTS = [  # per frame: (y, x, side, person)
    [(30, 60, 72, 1)],
    [(32, 64, 72, 1)],
    [(10, 10, 48, 1), (60, 110, 88, 2)],
    [],
    [(100, 150, 80, 1)],  # cut by the right and bottom borders
    [(2, 4, 64, 2)],  # within the v1 padding of the top-left corner
]


def video_frames():
    """Six 180 x 240 uint8 BGR frames (B = G = R) of mild noise holding the
    faces of ``VIDEO_PLANTS``."""
    rng = np.random.default_rng(23)
    gray = np.stack([scene((180, 240), plants, (100, 8), rng) for plants in VIDEO_PLANTS])
    return np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=3))


def write_video(path, frames, fps=25.0):
    """Write ``frames`` to ``path`` with OpenCV and return them as the
    decoder reads them back (the codec is lossy)."""
    from face_detection_recognization_pca_tpu_torch.io.video import VideoReader, VideoWriter

    writer = VideoWriter(path, (frames.shape[2], frames.shape[1]), fps)
    for frame in frames:
        writer.write(frame)
    writer.close()
    reader = VideoReader(path)
    decoded = np.stack(list(reader.frames()))
    reader.close()
    return decoded
