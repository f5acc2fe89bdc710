"""Host video decode and encode (port of ``io/video.py``).

GPUs' video engines are not used: decode and encode stay on the host
with OpenCV, as in the reference's ``cv2.VideoCapture`` /
``VideoWriter`` loops (``detection-v4.py:25-95``).  Frames are packed
into fixed-size batches for the device.  ``cv2`` is imported inside the
methods, so the module imports, and :class:`VideoMeta` serves, where
OpenCV is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class VideoMeta:
    width: int
    height: int
    fps: float
    frame_count: int


class VideoReader:
    """Thin cv2.VideoCapture wrapper with metadata."""

    def __init__(self, path: str):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.meta = VideoMeta(
            width=int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0,
            frame_count=int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            ret, frame = self.cap.read()
            if not ret:
                break
            yield frame

    def batches(
        self, batch: int, gray: bool = False, pad_last: bool = True
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (stacked frames, n_valid); last batch zero-padded."""
        import cv2

        buf = []
        for frame in self.frames():
            if gray:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            buf.append(frame)
            if len(buf) == batch:
                yield np.stack(buf), batch
                buf = []
        if buf:
            n = len(buf)
            if pad_last:
                while len(buf) < batch:
                    buf.append(np.zeros_like(buf[0]))
            yield np.stack(buf), n

    def close(self) -> None:
        self.cap.release()


class VideoWriter:
    def __init__(self, path: str, size_wh: Tuple[int, int], fps: float, fourcc: str = "mp4v"):
        import cv2

        self.writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), fps, size_wh
        )
        if not self.writer.isOpened():
            raise IOError(f"cannot open video writer: {path}")

    def write(self, frame: np.ndarray) -> None:
        self.writer.write(frame)

    def close(self) -> None:
        self.writer.release()
