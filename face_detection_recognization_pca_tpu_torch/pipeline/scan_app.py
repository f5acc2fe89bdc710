"""Recognition stage: guided video scanner + multi-model live scanner
(port of ``pipeline/scan_app.py``).

Two reference entry points reproduced:

* **video mode** (``scripts/manual|auto/scan-template-v2.py``): the
  training video's detection JSON is a position prior; per frame the
  guided matcher searches a 1.5x window around each nearby prior, the
  best hit is cropped, projected, cosine-matched (threshold 0.7), the
  frame annotated, and per-frame records accumulated into
  ``recognition_results.json`` next to ``recognition_output.mp4``
  (schema of ``scan-template-v2.py:536-598``).

* **live mode** (``scan-template-v4.py``): every person model's
  templates detect by full-frame multi-scale NCC, multi-face
  arbitration picks one detection (0.5 size + 0.5 PCA), PCA verifies
  across all models, names fuse per the v4 rules.  ``--live`` uses the
  webcam; any video path exercises the same logic offline.

The multi-model flows come in two forms.  :func:`scan_multimodel` and
:func:`scan_multimodel_batched` read a video file (or a camera) with
OpenCV and load models and templates from a lock directory.
:func:`scan_frames_multimodel` and :func:`scan_batches_multimodel` are
everything after the decoder and the loaders: functions of an iterator
of BGR frames (or frame batches), a :class:`ModelStack` and a
:class:`TemplateBank`, which need no OpenCV unless a writer is given
(the overlay is drawn with it).  There the frames are copied to the
device as uint8 BGR, and the gray conversion (OpenCV's fixed-point one,
bit for bit) and the crops are taken on the device.

The Haar and enhanced-model scans of the JAX package are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect.guided import GuidedMatcher
from face_detection_recognization_pca_tpu_torch.detect.template import (
    TemplateBank,
    TemplateDetector,
)
from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.artifacts import load_model
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    read_detection_json,
    reference_positions,
)
from face_detection_recognization_pca_tpu_torch.io.video import VideoReader, VideoWriter
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.ops.color import bgr_to_gray_exact
from face_detection_recognization_pca_tpu_torch.recognize.engine import (
    ModelStack,
    MultiModelRecognizer,
)
from face_detection_recognization_pca_tpu_torch.recognize.fusion import (
    UNKNOWN,
    arbitration_score,
    fuse_template_pca,
)
from face_detection_recognization_pca_tpu_torch.utils import annotate
from face_detection_recognization_pca_tpu_torch.utils.logging import Counters, get_logger

log = get_logger("fdrp.scan")


def _load_guided_assets(person_name: str, lock: str, device: torch.device):
    """Model + detection JSON + first-crop template for guided scans
    (reference loader ``scan-template-v2.py:90-125``)."""
    import cv2

    person_dir = os.path.join(lock, person_name)
    art = load_model(os.path.join(person_dir, "face_model.pkl"))
    model = ef.from_artifact(art, torch.float32, device)
    det_json = read_detection_json(
        os.path.join(person_dir, f"{person_name}_faces_detection.json")
    )
    # Template = first training crop (scan-template-v2.py:115-119).
    first = next((r for r in det_json.faces if r.image_path), None)
    tpath = first.image_path if first else None
    if tpath and not os.path.exists(tpath):
        tpath = os.path.join(person_dir, os.path.basename(str(tpath).replace("\\", "/")))
    template = cv2.imread(tpath, cv2.IMREAD_GRAYSCALE) if tpath else None
    if template is None:
        raise ValueError(f"no usable template crop for {person_name}")
    return art, model, det_json, template


def _recognize_crop(model, crop: np.ndarray, threshold: float):
    # One BGR host crop through the model on the model's device.
    if not crop.size:
        return -1, 0.0
    crops = torch.from_numpy(np.ascontiguousarray(crop[None])).to(model.components.device)
    ids, confs = ef.recognize(model, crops, threshold=threshold)
    return int(ids[0]), float(confs[0])


def scan_video_guided(
    video_path: str,
    person_name: str,
    lock_dir: Optional[str] = None,
    output_path: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> List[dict]:
    """Guided video recognition (scan-template-v2 video mode), computing
    on ``device`` (``None``: the CUDA device)."""
    import cv2

    cfg = config or PipelineConfig()
    device = resolve_device(device)
    lock = lock_dir or cfg.paths.lock_dir
    art, model, det_json, template = _load_guided_assets(person_name, lock, device)
    matcher = GuidedMatcher(template, cfg.detect.search_scale_video, device=device)

    reader = VideoReader(video_path)
    meta = reader.meta
    output_path = output_path or "recognition_output.mp4"
    writer = VideoWriter(output_path, (meta.width, meta.height), meta.fps)
    results: List[dict] = []
    counters = Counters()
    frame_no = 0
    names_by_id = art.names_by_id

    for frame in reader.frames():
        if max_frames is not None and frame_no >= max_frames:
            break
        counters.inc("frames")
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        priors = reference_positions(det_json, frame_no, cfg.detect.frame_tolerance)
        hit = matcher.match_frame(gray, priors, frame_no) if priors else None
        if hit is not None:
            counters.inc("frames_with_detection")
            x, y, w, h = hit["x"], hit["y"], hit["width"], hit["height"]
            pid, conf = _recognize_crop(
                model, frame[y : y + h, x : x + w], cfg.recognize.cosine_threshold
            )
            name = names_by_id.get(pid, UNKNOWN) if pid >= 0 else UNKNOWN
            if name != UNKNOWN:
                counters.inc("frames_recognized")
            results.append(
                {
                    "frame_number": int(frame_no),
                    "timestamp": float(frame_no / meta.fps if meta.fps else 0),
                    "x": int(x),
                    "y": int(y),
                    "width": int(w),
                    "height": int(h),
                    "person_id": int(pid),
                    "person_name": str(name),
                    "confidence": float(conf),
                    "template_match_confidence": float(hit["confidence"]),
                    "ref_frame_diff": int(hit.get("ref_frame_diff", 0)),
                }
            )
            annotate.draw_guided(frame, (x, y, w, h), name, conf)
        writer.write(frame)
        frame_no += 1
        if frame_no % 100 == 0:
            log.info("progress %d/%d frames", frame_no, meta.frame_count)

    reader.close()
    writer.close()
    results_path = (
        output_path.replace("recognition_output.mp4", "recognition_results.json")
        if output_path.endswith("recognition_output.mp4")
        else os.path.splitext(output_path)[0] + "_results.json"
    )
    with open(results_path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "video_path": video_path,
                "total_frames": meta.frame_count,
                "fps": meta.fps,
                "total_recognitions": len(results),
                "processing_date": datetime.now().isoformat(),
                "results": results,
            },
            f,
            indent=2,
            ensure_ascii=False,
        )
    log.info("\n%s", counters.recognition_summary())
    return results


def scan_live_guided(
    person_name: str,
    lock_dir: Optional[str] = None,
    camera_index: int = 0,
    output_path: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    frame_source=None,
    device: Optional[torch.device] = None,
) -> List[dict]:
    """Guided live-camera recognition (``FaceScanner.process_live_camera``,
    reference ``scripts/manual/scan-template-v2.py:298-423``).

    Live-mode semantics: the position prior is fixed to the training
    video's **frame-0** detections with tolerance 10 (``:326``), the
    search window is ``search_scale_live`` = 2.0x (``:343``), and a
    lower ``guided_threshold_live`` = 0.3 match gate (``:393``) admits
    the hit; the crop is PCA-recognized and overlaid with the
    ``"{name} ({conf:.2f}) TM:{tm:.2f}"`` label (``:401-408``).

    ``frame_source``: optional iterable of BGR frames replacing the
    webcam (tests / offline replay).  Unlike the reference (which
    returns an always-empty list, ``:319,423``), every admitted hit is
    recorded with the guided record schema.
    """
    import cv2

    cfg = config or PipelineConfig()
    device = resolve_device(device)
    lock = lock_dir or cfg.paths.lock_dir
    art, model, det_json, template = _load_guided_assets(person_name, lock, device)
    matcher = GuidedMatcher(template, cfg.detect.search_scale_live, device=device)
    # Frame-0 priors, computed once: live frames have no training-video
    # frame numbers to align to (scan-template-v2.py:326).
    priors = reference_positions(det_json, 0, cfg.detect.frame_tolerance_live)
    names_by_id = art.names_by_id

    closer = None
    if frame_source is None:
        cap = cv2.VideoCapture(camera_index)
        if not cap.isOpened():
            raise IOError(f"cannot open camera {camera_index}")
        frame_source = iter(lambda: cap.read()[1] if cap.isOpened() else None, None)
        closer = cap.release

    writer = None
    results: List[dict] = []
    counters = Counters()
    frame_no = 0
    try:
        for frame in frame_source:
            if frame is None or (max_frames is not None and frame_no >= max_frames):
                break
            counters.inc("frames")
            if writer is None and output_path:
                writer = VideoWriter(
                    output_path, (frame.shape[1], frame.shape[0]), cfg.video.live_fps
                )
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            hit = matcher.match_frame(gray, priors, frame_no) if priors else None
            if hit is not None and hit["confidence"] > cfg.detect.guided_threshold_live:
                counters.inc("frames_with_detection")
                x, y, w, h = hit["x"], hit["y"], hit["width"], hit["height"]
                pid, conf = _recognize_crop(
                    model, frame[y : y + h, x : x + w], cfg.recognize.cosine_threshold
                )
                name = names_by_id.get(pid, UNKNOWN) if pid >= 0 else UNKNOWN
                if name != UNKNOWN:
                    counters.inc("frames_recognized")
                annotate.draw_live_guided(frame, (x, y, w, h), name, conf, hit["confidence"])
                results.append(
                    {
                        "frame_number": int(frame_no),
                        "x": int(x),
                        "y": int(y),
                        "width": int(w),
                        "height": int(h),
                        "person_id": int(pid),
                        "person_name": str(name),
                        "confidence": float(conf),
                        "template_match_confidence": float(hit["confidence"]),
                    }
                )
            if writer is not None:
                writer.write(frame)
            frame_no += 1
    finally:
        if closer is not None:
            closer()
        if writer is not None:
            writer.close()
    log.info("\n%s", counters.recognition_summary())
    return results


def _record(frame_no: int, d, final_name: str, pconf: float, final_conf: float) -> dict:
    return {
        "frame_number": frame_no,
        "person_name": final_name,
        "template_confidence": float(d.confidence),
        "pca_confidence": float(pconf),
        "final_confidence": float(final_conf),
        "x": d.x,
        "y": d.y,
        "width": d.width,
        "height": d.height,
    }


def _load_multimodel_assets(lock: str, cfg: PipelineConfig, device: torch.device):
    stack = ModelStack.from_lock_dir(lock, device=device)
    # The reference only template-matches persons whose model loaded
    # (templates live in the per-model dict, scan-template-v4.py:46-74).
    bank = TemplateBank.from_person_dirs(
        lock,
        per_person=cfg.detect.templates_per_person,
        persons=set(stack.model_names),
        device=device,
    )
    return stack, bank


def scan_batches_multimodel(
    batches: Iterable[np.ndarray],
    stack: ModelStack,
    bank: TemplateBank,
    config: Optional[PipelineConfig] = None,
    writer=None,
    max_frames: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
) -> List[dict]:
    """The batched v4 multi-model scan over an iterator of frame batches
    (each ``(B, H, W, 3)`` uint8 BGR, a stack or a list of frames), on
    the bank's device.

    A whole batch runs through
    :meth:`~..detect.template.TemplateDetector.detect_fused_batch` and
    every crop of the batch is verified in
    :meth:`~..recognize.engine.MultiModelRecognizer.recognize_batch`
    grouped by box size (the fused detector emits few distinct sizes).
    Arbitration, fusion, overlay and the record schema are those of
    :func:`scan_frames_multimodel`.  With a ``writer`` the overlay is
    drawn (with OpenCV) and every frame written.

    ``timings``, when given, receives the seconds spent per stage
    (``upload_gray``, ``detect_device``, ``detect_select``, ``verify``,
    ``fuse``); the device is then waited for after each stage, which an
    untimed run does not do."""
    cfg = config or PipelineConfig()
    device = bank.device
    recognizer = MultiModelRecognizer(stack, cfg.recognize)
    detector = TemplateDetector(bank, cfg.detect)
    results: List[dict] = []
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        if timings is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[stage] = timings.get(stage, 0.0) + now - clock[0]
        clock[0] = now

    frame_no = 0
    for batch in batches:
        if max_frames is not None:
            if frame_no >= max_frames:
                break
            batch = batch[: max_frames - frame_no]
        host = batch if isinstance(batch, np.ndarray) else np.stack(batch)
        clock[0] = time.perf_counter()
        frames = torch.from_numpy(host).to(device)
        grays = bgr_to_gray_exact(frames)
        lap("upload_gray")
        scale_meta, packed = detector.detect_fused_device(grays)
        lap("detect_device")
        dets_per_frame = detector.detect_fused_finish(scale_meta, packed, len(host))
        dets_per_frame = [d[: cfg.detect.max_detections] for d in dets_per_frame]
        lap("detect_select")
        # Gather every crop of the batch, grouped by box size -> one
        # recognize_batch call per distinct size.
        jobs = [(bi, d) for bi, dets in enumerate(dets_per_frame) for d in dets]
        pca: dict = {}
        by_size: dict = {}
        for ji, (bi, d) in enumerate(jobs):
            crop = frames[bi, d.y : d.y + d.height, d.x : d.x + d.width]
            if crop.numel():
                by_size.setdefault(tuple(crop.shape), []).append((ji, crop))
            else:
                pca[ji] = (-1, UNKNOWN, 0.0)
        for items in by_size.values():
            outs = recognizer.recognize_batch(
                torch.stack([c for _, c in items]), cfg.recognize.pca_gate
            )
            for (ji, _), o in zip(items, outs):
                pca[ji] = o
        lap("verify")
        # Per-frame arbitration + fusion (identical to the per-frame path).
        job_of_frame: dict = {}
        for ji, (bi, d) in enumerate(jobs):
            job_of_frame.setdefault(bi, []).append((ji, d))
        for bi in range(len(host)):
            frame_jobs = job_of_frame.get(bi, [])
            if len(frame_jobs) > 1:
                best_sc, best = -1.0, None
                for ji, d in frame_jobs:
                    sc = arbitration_score(d.width, d.height, pca[ji][2], cfg.recognize)
                    if sc > best_sc:
                        best_sc, best = sc, (ji, d)
                frame_jobs = [best] if best else []
            for ji, d in frame_jobs:
                _, pname, pconf = pca[ji]
                final_name, final_conf = fuse_template_pca(
                    d.person_name, d.confidence, pname, pconf, cfg.recognize
                )
                if writer:
                    annotate.draw_v4(
                        host[bi], (d.x, d.y, d.width, d.height), final_name, d.confidence, pconf
                    )
                results.append(_record(frame_no + bi, d, final_name, pconf, final_conf))
            if writer:
                writer.write(host[bi])
        lap("fuse")
        frame_no += len(host)
    return results


def scan_multimodel_batched(
    source,
    lock_dir: Optional[str] = None,
    output_path: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    batch_frames: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> List[dict]:
    """Batched v4 multi-model scan of a video file (scan-template-v4
    semantics at batch granularity, reference
    ``scan-template-v4.py:321-437``): :func:`scan_batches_multimodel` fed
    by the decoder in batches of ``batch_frames``, with models and
    templates from the lock directory."""
    cfg = config or PipelineConfig()
    lock = lock_dir or cfg.paths.lock_dir
    stack, bank = _load_multimodel_assets(lock, cfg, resolve_device(device))
    nb = batch_frames or cfg.video.batch_frames

    reader = VideoReader(source)
    meta = reader.meta
    writer = VideoWriter(output_path, (meta.width, meta.height), meta.fps) if output_path else None
    try:
        return scan_batches_multimodel(
            (stack_ for stack_, _ in reader.batches(nb, pad_last=False)),
            stack,
            bank,
            cfg,
            writer=writer,
            max_frames=max_frames,
        )
    finally:
        reader.close()
        if writer:
            writer.close()


def scan_frames_multimodel(
    frames: Iterable[np.ndarray],
    stack: ModelStack,
    bank: TemplateBank,
    config: Optional[PipelineConfig] = None,
    writer=None,
    max_frames: Optional[int] = None,
    fused_detector: bool = True,
) -> List[dict]:
    """The per-frame v4 multi-model scan over an iterator of ``(H, W, 3)``
    uint8 BGR frames (a ``None`` frame ends it), on the bank's device;
    ``fused_detector=False`` takes the parity engine."""
    cfg = config or PipelineConfig()
    device = bank.device
    recognizer = MultiModelRecognizer(stack, cfg.recognize)
    detector = TemplateDetector(bank, cfg.detect)
    detect = detector.detect_fused if fused_detector else detector.detect_parity

    def verify(frame_t: torch.Tensor, d):
        crop = frame_t[d.y : d.y + d.height, d.x : d.x + d.width]
        if not crop.numel():
            return -1, UNKNOWN, 0.0
        return recognizer.recognize_one(crop, cfg.recognize.pca_gate)

    results: List[dict] = []
    frame_no = 0
    for frame in frames:
        if frame is None or (max_frames is not None and frame_no >= max_frames):
            break
        frame_t = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
        detections = detect(bgr_to_gray_exact(frame_t))[: cfg.detect.max_detections]

        # Multi-face arbitration (scan-template-v4.py:352-377).
        pca_cache = {}
        if len(detections) > 1:
            best_sc, best_det = -1.0, None
            for d in detections:
                pca_cache[id(d)] = verify(frame_t, d)
                sc = arbitration_score(d.width, d.height, pca_cache[id(d)][2], cfg.recognize)
                if sc > best_sc:
                    best_sc, best_det = sc, d
            detections = [best_det] if best_det else []

        for d in detections:
            _, pname, pconf = pca_cache[id(d)] if id(d) in pca_cache else verify(frame_t, d)
            final_name, final_conf = fuse_template_pca(
                d.person_name, d.confidence, pname, pconf, cfg.recognize
            )
            if writer:
                annotate.draw_v4(
                    frame, (d.x, d.y, d.width, d.height), final_name, d.confidence, pconf
                )
            results.append(_record(frame_no, d, final_name, pconf, final_conf))
        if writer:
            writer.write(frame)
        frame_no += 1
    return results


def scan_multimodel(
    source,
    lock_dir: Optional[str] = None,
    output_path: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    fused_detector: bool = True,
    device: Optional[torch.device] = None,
) -> List[dict]:
    """Multi-model scanning (scan-template-v4 semantics):
    :func:`scan_frames_multimodel` fed by the decoder, with models and
    templates from the lock directory.

    ``source``: video path, or an int camera index for live mode.
    """
    cfg = config or PipelineConfig()
    lock = lock_dir or cfg.paths.lock_dir
    stack, bank = _load_multimodel_assets(lock, cfg, resolve_device(device))

    if isinstance(source, int):
        import cv2

        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise IOError(f"cannot open camera {source}")
        meta_fps, meta_w, meta_h = 30.0, int(cap.get(3)), int(cap.get(4))
        frame_iter = iter(lambda: cap.read()[1] if cap.isOpened() else None, None)
        closer = cap.release
    else:
        reader = VideoReader(source)
        meta_fps = reader.meta.fps
        meta_w, meta_h = reader.meta.width, reader.meta.height
        frame_iter = reader.frames()
        closer = reader.close

    writer = VideoWriter(output_path, (meta_w, meta_h), meta_fps) if output_path else None
    try:
        return scan_frames_multimodel(
            frame_iter,
            stack,
            bank,
            cfg,
            writer=writer,
            max_frames=max_frames,
            fused_detector=fused_detector,
        )
    finally:
        closer()
        if writer:
            writer.close()
