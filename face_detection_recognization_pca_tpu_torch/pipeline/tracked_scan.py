"""Tracked batch video scanning (port of ``pipeline/tracked_scan.py``).

The reference's guided video scanner walks frames one at a time in
Python (``scripts/manual/scan-template-v2.py:460-573``).  This mode
keeps its semantics -- a training-crop template searched around a prior
box, PCA verification of the hit -- but runs the loop as the vectorized
tracker of :mod:`..parallel.multistream`:

* the first prior comes from the person's detection JSON;
* frames are decoded in batches, each batch is copied to the device
  once, and the tracked box feeds forward frame to frame there;
* results use the guided scanner's record schema, so downstream tooling
  cannot tell which engine produced them.

The tracker processes a single stream here, so consecutive frames fill
the time axis of :meth:`MultiStreamRecognizer.process_window`: each
frame searches around the previous frame's box, and the host reads the
results once per batch.

:func:`scan_video_tracked` reads a video file with OpenCV.
:func:`scan_batches_tracked` is everything after the decoder, a function
of an iterator of frame batches, and needs no OpenCV once the template
is given.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.artifacts import load_model
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    read_detection_json,
)
from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta, VideoReader
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.ops.resize import (
    resize_bilinear_u8_exact,
)
from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
    MultiStreamRecognizer,
)
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger

log = get_logger("fdrp.tracked")


def scan_batches_tracked(
    batches: Iterable[Tuple[np.ndarray, int]],
    meta: VideoMeta,
    person_name: str,
    lock_dir: Optional[str] = None,
    output_json: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    template_side: Optional[int] = None,
    window: Optional[int] = None,
    max_frames: Optional[int] = None,
    device: Optional[torch.device] = None,
    video_path: str = "",
    template_full: Optional[np.ndarray] = None,
) -> List[dict]:
    """Track+recognize frame batches: ``batches`` yields ``(uint8 stack
    (T, H, W) gray, n_valid)`` as :meth:`..io.video.VideoReader.batches`
    does, and ``meta`` describes the video they come from.

    The model and the prior box are read from ``lock_dir/person_name``
    (``face_model.pkl`` and ``<person>_faces_detection.json``).  The
    template is the first detection record's crop image, read with
    OpenCV, unless ``template_full`` gives it as a uint8 gray array.
    ``device=None`` means the CUDA device; ``video_path`` is only written
    into ``output_json``.  Returns guided-scanner-style records."""
    cfg = config or PipelineConfig()
    device = resolve_device(device)
    lock = lock_dir or cfg.paths.lock_dir
    person_dir = os.path.join(lock, person_name)
    art = load_model(os.path.join(person_dir, "face_model.pkl"))
    model = ef.from_artifact(art, torch.float32, device)
    det_json = read_detection_json(
        os.path.join(person_dir, f"{person_name}_faces_detection.json")
    )
    first = next((r for r in det_json.faces if r.image_path), None)
    if template_full is None:
        import cv2

        tpath = first.image_path if first else None
        if tpath and not os.path.exists(tpath):
            tpath = os.path.join(
                person_dir, os.path.basename(str(tpath).replace("\\", "/"))
            )
        template_full = cv2.imread(tpath, cv2.IMREAD_GRAYSCALE) if tpath else None
    if template_full is None:
        raise ValueError(f"no usable template crop for {person_name}")

    if template_side is None:
        # Match the prior's face size (the guided scanner resizes the
        # template to the reference box -- scan-template-v2.py:502),
        # rounded to a multiple of 32 and frame-bounded.
        prior_side = (
            first.width if first and first.width > 0 else template_full.shape[0]
        )
        template_side = int(np.clip(round(prior_side / 32) * 32, 64, 256))
        template_side = min(
            template_side, (min(meta.height, meta.width) // 64) * 32
        )
    if window is None:
        window = min(2 * template_side, (min(meta.height, meta.width) // 32) * 32)
        window = max(window, template_side + 32)
    template = (
        resize_bilinear_u8_exact(
            torch.from_numpy(np.ascontiguousarray(template_full)),
            (template_side, template_side),
        )
        .numpy()
        .astype(np.float32)
    )
    log.info(
        "tracked scan: template %dpx, window %dpx", template_side, window
    )
    msr = MultiStreamRecognizer(model, template, window=window)

    # Prior box from the detection JSON's first record (scaled to the
    # tracker's template size), else centered.
    if first and first.width > 0:
        cx = first.center_x
        cy = first.center_y
        box = np.array(
            [[cx - template_side // 2, cy - template_side // 2, 0, 0]]
        )
        state = msr.init_state(1, (meta.height, meta.width), box)
        prior_frame = int(first.frame_number)
    else:
        state = msr.init_state(1, (meta.height, meta.width))
        prior_frame = 0

    names_by_id = art.names_by_id
    results: List[dict] = []
    frame_no = 0
    for stack, n_valid in batches:
        if max_frames is not None and frame_no >= max_frames:
            break
        # (T, S=1, H, W): the batch is the TIME axis; the tracked box
        # feeds forward frame-to-frame on the device.  The uint8 stack is
        # copied over as it is and widened there.
        frames = torch.from_numpy(stack).to(device).to(torch.float32)[:, None]
        out, state = msr.process_window(frames, state)
        pid, conf, tm, xs, ys = (
            out[key][:, 0].cpu().numpy()
            for key in ("person_id", "confidence", "template_confidence", "x", "y")
        )
        for i in range(n_valid):
            p = int(pid[i])
            c = float(conf[i])
            recognized = c >= cfg.recognize.cosine_threshold
            results.append(
                {
                    "frame_number": frame_no,
                    "timestamp": float(frame_no / meta.fps if meta.fps else 0),
                    "x": int(xs[i]),
                    "y": int(ys[i]),
                    "width": template_side,
                    "height": template_side,
                    "person_id": p if recognized else -1,
                    "person_name": str(
                        names_by_id.get(p, "unknown") if recognized else "unknown"
                    ),
                    "confidence": c,
                    "template_match_confidence": float(tm[i]),
                    # Frame distance to the prior actually used: the
                    # previous frame's tracked box (the JSON prior for
                    # the very first frame) -- the tracker's analog of
                    # the reference's best_match['ref_frame_diff']
                    # (scan-template-v2.py:549).
                    "ref_frame_diff": abs(frame_no - prior_frame),
                }
            )
            prior_frame = frame_no
            frame_no += 1

    if output_json:
        with open(output_json, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "video_path": video_path,
                    "total_frames": meta.frame_count,
                    "fps": meta.fps,
                    "total_recognitions": len(results),
                    "processing_date": datetime.now().isoformat(),
                    "engine": "tracked-multistream",
                    "results": results,
                },
                f,
                indent=2,
                ensure_ascii=False,
            )
    log.info(
        "tracked scan: %d frames, %d recognized",
        len(results),
        sum(1 for r in results if r["person_name"] != "unknown"),
    )
    return results


def scan_video_tracked(
    video_path: str,
    person_name: str,
    lock_dir: Optional[str] = None,
    output_json: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    batch: int = 16,
    template_side: Optional[int] = None,
    window: Optional[int] = None,
    max_frames: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> List[dict]:
    """Track+recognize a whole video file in frame batches, decoded with
    OpenCV: :func:`scan_batches_tracked` fed by
    :meth:`..io.video.VideoReader.batches`.

    Returns guided-scanner-style records (no annotated video: this is
    the throughput path)."""
    reader = VideoReader(video_path)
    try:
        return scan_batches_tracked(
            reader.batches(batch, gray=True),
            reader.meta,
            person_name,
            lock_dir=lock_dir,
            output_json=output_json,
            config=config,
            template_side=template_side,
            window=window,
            max_frames=max_frames,
            device=device,
            video_path=video_path,
        )
    finally:
        reader.close()
