"""Host video decode and encode (port of ``io/video.py``).

GPUs' video engines are not used: decode and encode stay on the host
with OpenCV, as in the reference's ``cv2.VideoCapture`` /
``VideoWriter`` loops (``detection-v4.py:25-95``).  Frames are packed
into fixed-size batches for the device, and :class:`PrefetchingFeed`
decodes them on a background thread ahead of the consumer.  ``cv2`` is
imported inside the methods, so the module imports, and
:class:`VideoMeta` serves, where OpenCV is absent.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
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


class PrefetchingFeed:
    """Background decode thread + bounded queue; overlaps host decode
    with device compute (the double-buffered feed of SURVEY §7.6).
    Iterating yields :meth:`VideoReader.batches`' items in order."""

    def __init__(self, reader: VideoReader, batch: int, gray: bool, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(
            target=self._run, args=(reader, batch, gray), daemon=True
        )
        self._thread.start()

    def _run(self, reader, batch, gray):
        try:
            for item in reader.batches(batch, gray=gray):
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item


def record_camera(
    output_path: str,
    seconds: float = 10.0,
    fps: int = 30,
    size_wh: Tuple[int, int] = (640, 480),
    camera_index: int = 0,
    show_preview: bool = False,
) -> int:
    """Webcam recording for --live mode (run_pipeline.py:71-137).

    Returns frames written; raises IOError when no camera exists.
    """
    import cv2

    cap = cv2.VideoCapture(camera_index)
    if not cap.isOpened():
        raise IOError(f"cannot open camera {camera_index}")
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, size_wh[0])
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, size_wh[1])
    cap.set(cv2.CAP_PROP_FPS, fps)
    writer = VideoWriter(output_path, size_wh, fps)
    target = int(seconds * fps)
    written = 0
    try:
        while written < target:
            ret, frame = cap.read()
            if not ret:
                break
            writer.write(frame)
            written += 1
            if show_preview:
                cv2.imshow("recording", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        cap.release()
        writer.close()
        if show_preview:
            cv2.destroyAllWindows()
    return written
