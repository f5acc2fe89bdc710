"""Detection-JSON schema I/O and the filename-regex backfill generator
(the port's own copy of the JAX package's ``io/detection_json.py``; both
read and write the same files).

Schema parity: reference ``detection-v4.py:71-84,98-105`` -- header
``video_path, total_frames, fps, total_faces_detected, processing_date``
plus per-face records ``face_id, frame_number, timestamp, x, y, width,
height, center_x, center_y, area, image_path, image_filename``.

The backfill generator reproduces ``train-v5.py:33-142`` /
``generate_detection_json.py:8-117``: scan a bare person directory,
skip model artifacts, pull frame numbers out of
``face_\\d+_frame_(\\d+)`` or ``_face_(\\d+)`` filenames, assume 30 fps,
and emit records with x = y = 0 and the real image dimensions.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import asdict, dataclass, field
from datetime import datetime
from typing import List, Optional


@dataclass
class DetectionRecord:
    face_id: int
    frame_number: int
    timestamp: float
    x: int
    y: int
    width: int
    height: int
    center_x: int
    center_y: int
    area: int
    image_path: str
    image_filename: str


@dataclass
class DetectionFile:
    video_path: str
    total_frames: int
    fps: float
    total_faces_detected: int
    processing_date: str
    faces: List[DetectionRecord] = field(default_factory=list)


def write_detection_json(det: DetectionFile, path: str) -> None:
    payload = {
        "video_path": det.video_path,
        "total_frames": det.total_frames,
        "fps": det.fps,
        "total_faces_detected": det.total_faces_detected,
        "processing_date": det.processing_date,
        "faces": [asdict(r) for r in det.faces],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, ensure_ascii=False)


def read_detection_json(path: str) -> DetectionFile:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    faces = [
        DetectionRecord(
            face_id=r.get("face_id", i),
            frame_number=r.get("frame_number", 0),
            timestamp=r.get("timestamp", 0.0),
            x=r.get("x", 0),
            y=r.get("y", 0),
            width=r.get("width", 0),
            height=r.get("height", 0),
            center_x=r.get("center_x", r.get("x", 0) + r.get("width", 0) // 2),
            center_y=r.get("center_y", r.get("y", 0) + r.get("height", 0) // 2),
            area=r.get("area", r.get("width", 0) * r.get("height", 0)),
            image_path=r.get("image_path", ""),
            image_filename=r.get("image_filename", ""),
        )
        for i, r in enumerate(data.get("faces", []))
    ]
    return DetectionFile(
        video_path=data.get("video_path", ""),
        total_frames=data.get("total_frames", 0),
        fps=data.get("fps", 30.0),
        total_faces_detected=data.get("total_faces_detected", len(faces)),
        processing_date=data.get("processing_date", ""),
        faces=faces,
    )


# Filename patterns of the reference generations
# (train-v5.py:60-76; useless/detection.py:115).
_FRAME_PATTERNS = (
    re.compile(r"face_\d+_frame_(\d+)"),
    re.compile(r"_face_(\d+)"),
)
_SKIP_TOKENS = ("eigenface", "mean_face", "model_info")
_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _frame_number(filename: str, fallback: int) -> int:
    for pat in _FRAME_PATTERNS:
        m = pat.search(filename)
        if m:
            return int(m.group(1))
    return fallback


def generate_detection_json(
    person_dir: str,
    person_name: Optional[str] = None,
    fps: float = 30.0,
    output_path: Optional[str] = None,
    image_size_fn=None,
) -> DetectionFile:
    """Backfill a detection JSON from a bare directory of crops.

    ``image_size_fn(path) -> (h, w)`` defaults to a cv2 probe; inject a
    fake in tests to avoid decoding.
    """
    person_name = person_name or os.path.basename(os.path.normpath(person_dir))
    if image_size_fn is None:
        def image_size_fn(p):
            import cv2

            img = cv2.imread(p)
            return (0, 0) if img is None else img.shape[:2]

    names = sorted(
        n
        for n in os.listdir(person_dir)
        if n.lower().endswith(_IMG_EXTS)
        and not any(tok in n.lower() for tok in _SKIP_TOKENS)
    )
    faces: List[DetectionRecord] = []
    max_frame = 0
    for i, name in enumerate(names):
        path = os.path.join(person_dir, name)
        h, w = image_size_fn(path)
        frame = _frame_number(name, fallback=i)
        max_frame = max(max_frame, frame)
        faces.append(
            DetectionRecord(
                face_id=i,
                frame_number=frame,
                timestamp=frame / fps,
                x=0,
                y=0,
                width=int(w),
                height=int(h),
                center_x=int(w) // 2,
                center_y=int(h) // 2,
                area=int(w) * int(h),
                image_path=path,
                image_filename=name,
            )
        )
    det = DetectionFile(
        video_path=f"generated_from_{person_name}_images",
        total_frames=max_frame + 1,
        fps=fps,
        total_faces_detected=len(faces),
        processing_date=datetime.now().isoformat(),
        faces=faces,
    )
    if output_path:
        write_detection_json(det, output_path)
    return det


def reference_positions(
    det: DetectionFile, frame_number: int, tolerance: int = 5
) -> List[DetectionRecord]:
    """Training-video detections within +-tolerance frames, the position
    prior of the guided scanner (reference
    ``scripts/manual/scan-template-v2.py:127-161``).

    Sorted by frame distance (closest first, stable within ties) like the
    reference's ``reference_positions.sort(key=frame_diff)`` -- so on
    equal match confidence the closest-frame prior wins, and the
    recorded ``ref_frame_diff`` matches the reference's."""
    near = [
        r
        for r in det.faces
        if abs(r.frame_number - frame_number) <= tolerance
    ]
    near.sort(key=lambda r: abs(r.frame_number - frame_number))
    return near
