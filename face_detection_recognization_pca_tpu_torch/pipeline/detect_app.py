"""Detection stage: video -> face crops + detection JSON (port of
``pipeline/detect_app.py``).

Parity with reference ``detection-v4.py``: Haar detectMultiScale with
(1.1, 5, (30, 30)), raw BGR crops saved as
``face_{face_id:06d}_frame_{frame:06d}.jpg`` under
``faces/lock_version/<person>/``, and the detection-JSON schema of
``detection-v4.py:71-84,98-105``.

:func:`detect_video_v1` reproduces the v1 generation
(``useless/detection.py``) that produced the shipped
``faces/{Light,Dark}_version`` datasets: 20 px padded boxes, crops
resized to 100x100, ``{person}_face_{id:04d}.jpg`` naming with
resumable id numbering, and a ``{video}_metadata.json`` sidecar.

Each comes in two forms.  :func:`detect_video` and :func:`detect_video_v1`
read a video file and write each JPEG with OpenCV as its face is found.
:func:`detect_frames` and :func:`detect_frames_v1` are everything between
the decoder and ``cv2.imwrite``: functions of an iterator of uint8 BGR
frames that hand every crop to ``on_crop`` (or return them) and need no
OpenCV.  There the frames are copied to the detector's device as uint8 BGR,
:data:`DETECT_BATCH` at a time, and the gray conversion and the v1 crop
resize (both OpenCV's fixed-point arithmetic, bit for bit) run there.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    DetectionFile,
    DetectionRecord,
    write_detection_json,
)
from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta, VideoReader
from face_detection_recognization_pca_tpu_torch.ops.color import bgr_to_gray_exact
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear_u8_exact
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger
from face_detection_recognization_pca_tpu_torch.utils.profiling import span

log = get_logger("fdrp.detect")

# Frames that go through the detector at once, in every app on it.  The
# boxes are those of frame-by-frame calls.
DETECT_BATCH = 16


def haar_batches(
    frames: Iterable[np.ndarray],
    detector: HaarDetector,
    config: PipelineConfig,
    max_frames: Optional[int] = None,
) -> Iterator[Tuple[List[np.ndarray], torch.Tensor, List[list]]]:
    """``(frames, grays, faces)`` per batch of up to :data:`DETECT_BATCH`
    uint8 BGR frames of ``frames`` (a ``None`` frame ends them): the frames
    as given, their OpenCV-exact gray converted on the detector's device
    (``(B, H, W)`` uint8 there), and the detector's boxes per frame with
    the config's parameters."""
    cfg = config.detect
    pending: List[np.ndarray] = []

    def flush():
        with span("scan.upload"):
            grays = bgr_to_gray_exact(torch.from_numpy(np.stack(pending)).to(detector.device))
        faces = detector.detect_multi_scale_batch(
            grays, cfg.scale_factor, cfg.min_neighbors, cfg.min_size
        )
        batch = (list(pending), grays, faces)
        pending.clear()
        return batch

    for n, frame in enumerate(frames):
        if frame is None or (max_frames is not None and n >= max_frames):
            break
        pending.append(frame)
        if len(pending) == DETECT_BATCH:
            yield flush()
    if pending:
        yield flush()


def haar_faces_per_frame(
    frames: Iterable[np.ndarray],
    detector: HaarDetector,
    config: PipelineConfig,
    max_frames: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, list]]:
    """``(frame, faces)`` per uint8 BGR frame of ``frames`` (a ``None`` frame
    ends them): the frame as given and the detector's boxes, with the
    config's parameters, on its OpenCV-exact gray, converted on the
    detector's device, :data:`DETECT_BATCH` frames at a time."""
    for batch, _, faces in haar_batches(frames, detector, config, max_frames):
        yield from zip(batch, faces)


def detect_frames(
    frames: Iterable[np.ndarray],
    meta: VideoMeta,
    config: Optional[PipelineConfig] = None,
    detector: Optional[HaarDetector] = None,
    max_frames: Optional[int] = None,
    video_path: str = "",
    out_dir: str = "",
    progress_every: int = 30,
    on_crop: Optional[Callable[[DetectionRecord, np.ndarray], None]] = None,
) -> Tuple[DetectionFile, List[np.ndarray]]:
    """The detection stage over an iterator of ``(H, W, 3)`` uint8 BGR
    frames: the :class:`DetectionFile` that :func:`detect_video` writes
    and, record for record, the raw BGR crops it saves.  With ``on_crop``
    each ``(record, crop)`` goes there as it is found and no crop is kept
    or returned.  ``out_dir`` is where the records' ``image_path`` point.
    ``detector=None`` builds one on the CUDA device."""
    cfg = config or PipelineConfig()
    detector = detector or HaarDetector()
    records: List[DetectionRecord] = []
    crops: List[np.ndarray] = []
    sink = on_crop or (lambda record, crop: crops.append(crop.copy()))
    frame_no = 0
    for frame, faces in haar_faces_per_frame(frames, detector, cfg, max_frames):
        for (x, y, w, h) in faces:
            crop = frame[y : y + h, x : x + w]
            if crop.size == 0:
                continue
            face_id = len(records)
            fname = f"face_{face_id:06d}_frame_{frame_no:06d}.jpg"
            records.append(
                DetectionRecord(
                    face_id=face_id,
                    frame_number=frame_no,
                    timestamp=frame_no / meta.fps,
                    x=int(x),
                    y=int(y),
                    width=int(w),
                    height=int(h),
                    center_x=int(x + w // 2),
                    center_y=int(y + h // 2),
                    area=int(w * h),
                    image_path=os.path.join(out_dir, fname) if out_dir else fname,
                    image_filename=fname,
                )
            )
            sink(records[-1], crop)
        frame_no += 1
        if progress_every and frame_no % progress_every == 0:
            log.info("processed %d frames, %d faces", frame_no, len(records))
    det = DetectionFile(
        video_path=video_path,
        total_frames=frame_no,
        fps=meta.fps,
        total_faces_detected=len(records),
        processing_date=datetime.now().isoformat(),
        faces=records,
    )
    return det, crops


def detect_video(
    video_path: str,
    person_name: str,
    output_root: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    detector: Optional[HaarDetector] = None,
    max_frames: Optional[int] = None,
    progress_every: int = 30,
) -> DetectionFile:
    """Run detection over a video and persist crops + JSON.

    Returns the in-memory DetectionFile (also written to
    ``<output_root>/<person>/<person>_faces_detection.json``).
    """
    import cv2

    cfg = config or PipelineConfig()
    out_dir = os.path.join(output_root or cfg.paths.lock_dir, person_name)
    os.makedirs(out_dir, exist_ok=True)

    reader = VideoReader(video_path)
    try:
        det, _ = detect_frames(
            reader.frames(), reader.meta, cfg, detector, max_frames, video_path, out_dir,
            progress_every, on_crop=lambda record, crop: cv2.imwrite(record.image_path, crop),
        )
    finally:
        reader.close()
    json_path = os.path.join(out_dir, f"{person_name}_faces_detection.json")
    write_detection_json(det, json_path)
    log.info("wrote %d faces to %s", det.total_faces_detected, json_path)
    return det


def next_face_id(output_dir: str, person_name: str) -> int:
    """Next available v1 face id: max over existing
    ``{person}_face_{id:04d}.jpg`` files + 1, starting at 1
    (reference ``useless/detection.py:8-35``)."""
    if not os.path.isdir(output_dir):
        return 1
    max_id = 0
    prefix = f"{person_name}_face_"
    for name in os.listdir(output_dir):
        if name.startswith(prefix) and name.endswith(".jpg"):
            try:
                max_id = max(max_id, int(name[len(prefix) : -4]))
            except ValueError:
                continue
    return max_id + 1


def detect_frames_v1(
    frames: Iterable[np.ndarray],
    video_name: str,
    person_name: str,
    starting_face_id: int = 1,
    config: Optional[PipelineConfig] = None,
    detector: Optional[HaarDetector] = None,
    max_frames: Optional[int] = None,
    padding: int = 20,
    crop_size: int = 100,
    progress_every: int = 100,
    on_crop: Optional[Callable[[dict, np.ndarray], None]] = None,
) -> Tuple[dict, List[np.ndarray], int]:
    """The v1 detection stage over an iterator of uint8 BGR frames:
    ``(metadata, crops, frames seen)``, the metadata dict that
    :func:`detect_video_v1` writes and, face for face, the padded crops
    resized to ``crop_size`` square as ``cv2.resize`` resizes them.  With
    ``on_crop`` each ``(face entry, crop)`` goes there as it is found and
    no crop is kept or returned."""
    cfg = config or PipelineConfig()
    detector = detector or HaarDetector()
    metadata = {
        "video_name": video_name,
        "person_name": person_name,
        "detection_timestamp": datetime.now().isoformat(),
        "faces": [],
    }
    crops: List[np.ndarray] = []
    sink = on_crop or (lambda face, crop: crops.append(crop))
    frame_count = 0
    for frame, faces in haar_faces_per_frame(frames, detector, cfg, max_frames):
        frame_count += 1  # v1 counts frames from 1 (detection.py:81)
        for (x, y, w, h) in faces:
            x0 = max(0, x - padding)
            y0 = max(0, y - padding)
            x1 = min(frame.shape[1], x + w + padding)
            y1 = min(frame.shape[0], y + h + padding)
            crop = frame[y0:y1, x0:x1]
            if crop.size == 0:
                continue
            current_face_id = starting_face_id + len(metadata["faces"])
            planes = torch.from_numpy(np.ascontiguousarray(crop.transpose(2, 0, 1)))
            resized = resize_bilinear_u8_exact(planes.to(detector.device), (crop_size, crop_size))
            metadata["faces"].append(
                {
                    "face_id": current_face_id,
                    "frame_number": frame_count,
                    "filename": f"{person_name}_face_{current_face_id:04d}.jpg",
                    "bbox": {
                        "x": int(x),
                        "y": int(y),
                        "width": int(w),
                        "height": int(h),
                    },
                    "face_size": {"width": crop_size, "height": crop_size},
                }
            )
            sink(metadata["faces"][-1], resized.permute(1, 2, 0).contiguous().cpu().numpy())
        if progress_every and frame_count % progress_every == 0:
            log.info("processed %d frames, found %d faces", frame_count, len(metadata["faces"]))
    return metadata, crops, frame_count


def detect_video_v1(
    video_path: str,
    output_dir: str,
    person_name: str,
    config: Optional[PipelineConfig] = None,
    detector: Optional[HaarDetector] = None,
    max_frames: Optional[int] = None,
    padding: int = 20,
    crop_size: int = 100,
    progress_every: int = 100,
) -> dict:
    """v1-generation detection (``useless/detection.py:37-156``).

    Per frame: Haar detect, pad each box ``padding`` px clamped to the
    frame, resize the BGR crop to ``crop_size`` square, save as
    ``{person}_face_{id:04d}.jpg`` (ids resume from existing files via
    :func:`next_face_id`), and record metadata.  Writes
    ``{video_stem}_metadata.json`` next to the crops and a
    :class:`~..io.checkpoint.StageState` sidecar; returns the metadata
    dict (``video_name, person_name, detection_timestamp, faces[]`` with
    ``face_id, frame_number, filename, bbox, face_size`` per face).
    """
    import cv2

    from face_detection_recognization_pca_tpu_torch.io.checkpoint import StageState

    os.makedirs(output_dir, exist_ok=True)
    state_path = os.path.join(output_dir, f".{person_name}_detect_v1_state.json")
    state = StageState.load(state_path, default_stage="detect_v1")
    # Resume rule: filename scan is the reference's source of truth
    # (useless/detection.py:60); the StageState only corroborates it
    # (covers externally-deleted crops without reusing ids).
    starting_face_id = max(next_face_id(output_dir, person_name), state.next_face_id or 1)

    def write(face, crop):
        cv2.imwrite(os.path.join(output_dir, face["filename"]), crop)

    reader = VideoReader(video_path)
    try:
        metadata, _, frame_count = detect_frames_v1(
            reader.frames(), os.path.basename(video_path), person_name, starting_face_id,
            config, detector, max_frames, padding, crop_size, progress_every,
            on_crop=write,
        )
    finally:
        reader.close()

    state.last_frame = frame_count - 1
    state.next_face_id = starting_face_id + len(metadata["faces"])
    state.save(state_path)

    video_stem = os.path.basename(video_path).split(".")[0]
    meta_path = os.path.join(output_dir, f"{video_stem}_metadata.json")
    with open(meta_path, "w", encoding="utf-8") as f:
        json.dump(metadata, f, indent=2, ensure_ascii=False)
    log.info(
        "v1 detection: %d frames, %d faces, metadata -> %s",
        frame_count, len(metadata["faces"]), meta_path,
    )
    return metadata
