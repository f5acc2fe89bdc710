#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. environment: torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``), both TF32 switches turned off and checked;
2. build: ``csrc/fused_match.cu`` and ``csrc/gallery_match.cu`` (both
   including ``csrc/mma_sync.cuh``) compiled with nvcc for sm_90a, both
   at once, with ptxas's register and spill counts per kernel, and the
   number of ``HMMA`` (tensor-core) instructions in each kernel of both
   libraries from ``cuobjdump --dump-sass``: every instantiation of the
   gallery tile kernel and of the fused-match kernel must have some;
3. fused kernel against plain: ``fused_match`` against
   ``recognize_linearized`` on the card at the tracker's shapes, a ragged
   masked case, an exact tie, a zero-norm crop, k = 300, B = 130 (three
   64-crop tiles), k = 7 (rows off 16-byte boundaries, element loads),
   B = 512 (the headline's batch) and B = 1 (the scan's): ids equal, conf
   within 1e-5; then two calls and a CUDA graph's replays must give the
   same bits.  Kernel, plain and ``crops @ m`` (``library_ms``) are timed
   in the order plain, kernel, library, library, kernel, plain, by CUDA
   events around 200 Python calls and around replays of a CUDA graph of
   50 calls (the card alone, the ``ms`` of the JSON line), with
   ``torch.profiler``'s kernel sums as a cross-check, beside the card's
   bound for the same work; the same at B = 512 (``b512`` in the JSON
   line);
4. the tracker slice: ``bench.tracker_recognizer`` at 1080p with 64
   streams and 8 frame batches (seed 4), a snapshot-PCA model trained on
   the card, then 8 ``process_batch`` steps and one 8-frame
   ``process_window``; every position and gallery row must be the planted
   one, and the kernel's launch count must show that both paths went
   through it.  Then ``bench.tracker`` at the same size, which must
   publish both fps at its planted-exact check, with 64 launches;
5. gallery kernel against plain: ``gallery_match`` against
   ``_gallery_match_plain`` at the JAX shape (B 1024, k 128, N 131072) in
   float32 and bfloat16, ragged B and N, sentinel rows, a valid zero-norm
   row, a zero-norm feature, a tie across tiles and all-negative cosines;
   ids equal (on random data a differing id must be a near-tie, plain
   cosines within 1e-5), conf within 1e-5 (float32) or 2e-3 (bfloat16
   against a plain version with the same rounding); ``bench.large_gallery``
   times both, beside ``torch.matmul`` of the same operands
   (``library_ms``, the product alone) and the card's bound;
6. the large-gallery slice: ``large_gallery_assets`` with B 1024, k 128,
   N 1,048,573; ``sharded_gallery_match`` on the (1, 1) mesh and on a
   model = 8 mesh over the one card, in float32 and bfloat16, must name
   every probe by its planted label and agree with the dense plain
   reference, with one kernel launch per shard (kernel, plain,
   ``library_ms`` and bound timed on one shard); then ``dp_recognize``
   against ``recognize`` on 1024 crops, and ``multichip_train_step`` on
   2048 images of 64 x 64 with k = 128 on both meshes against the dense
   ``snapshot_pca``;
7. the headline, the metric of record: ``bench.headline`` at 1080p with
   16 streams and 32 frame batches, 512 windows of 192 x 192 per dispatch
   through the tracker's step math and one ``fused_match`` launch (B =
   512, D = 9216, k = 64, N = 256).  It prints frames/s/card, the step's
   ms, the kernels' ms and launches per dispatch and their share of the
   step (``torch.profiler``), TFLOP/s by the closed form, and the seconds
   of a 969 x 4096, k = 100 PCA training, each timing window on the host
   clock and by CUDA events, and the float32 peak's share.  Every planted
   offset and gallery row must be exact and the kernel must have been
   launched.  Then ``bench.headline_geom256`` (window 256, template 128,
   24 streams x 32 batches: one launch at B = 768, D = 16384 per
   dispatch), planted-exact, and the fused kernel held against plain at
   that shape and timed beside plain, ``crops @ m`` and the bound
   (``b768_d16384`` in the JSON line);
8. the tracked scan of one video, without OpenCV: a model trained on the
   card is written with ``to_artifact`` + ``save_model_v1`` into a
   temporary lock directory beside a detection JSON, read back by
   ``scan_batches_tracked``, and 256 uint8 1080p frames made on the host
   (``bench.scan_assets``, a face that drifts up to 3 px per frame) are
   fed in batches of 16.  Every record must hold the planted position and
   the enrolled person, with one ``fused_match`` launch per frame.  Its
   frames/s include the host-to-device copy of every batch;
9. the full-frame template detector: ``bench.full_frame_detect``, batch
   16, 8 templates of 128 x 128 for 4 persons at scales 0.8 / 1.0 / 1.2
   (seed 3), the clean template planted at the centre, at 544p and at
   1080p.  Every frame must give exactly one detection after NMS, the
   planted box, above the threshold, and ``detect_parity`` on frame 0 must
   name the same box.  It prints frames/s end to end and for the device
   half alone, and the device ms per batch by kernel family
   (``torch.profiler``: FFT, matmuls split into the resize and the banded
   window sums by timing the resize alone, elementwise, reductions);
10. the batched multi-model scan, without OpenCV or files:
    ``bench.multimodel_scan_assets`` (4 persons, a ``train_v2`` model and
    two templates each, trained on the card) and 64 uint8 BGR 1080p frames
    in batches of 16 through ``scan_batches_multimodel``.  One record per
    frame must hold the planted box and person with template confidence
    above 0.7 and PCA confidence above 0.8, and the per-frame
    ``scan_frames_multimodel`` must give the same records.  Then each
    person's 16 admitted crops go through ``make_fused_recognizer`` of that
    person's model at (128, 128), D = 16384: rows equal to
    ``recognize_linearized``'s, confidence within 1e-5, one launch per
    call.  It prints frames/s with the copies inside and the seconds per
    stage, and times the kernel at D = 16384 beside plain, ``crops @ m``
    and the bound (``d16384`` in the JSON line);
11. the Haar cascade detector: ``bench.haar_detect``, batch 16 at 544p
    (seed 5): noise frames ``110 + 25 N(0, 1)`` made on the card, each with
    one synthetic face that the frontal-face cascade accepts
    (``bench.haar_face``) at a seeded side of 60-220 px and a seeded place.
    It prints which cascade file was read and its sha256.  Every frame must
    give a box whose centre lies within 0.1 of the side of the planted
    centre and whose side lies within [0.9, 1.25] of it; the batch must
    equal the frames taken one by one; frames 0-1 on the card must give
    the boxes the same detector gives on the CPU; and on the level of
    frame 0 that accepts most windows, the card's accepted windows must
    equal those of a float64 numpy cascade written in this file.  It
    prints levels, windows per frame, the candidates left after each
    compaction, raw rectangles, other boxes, blocking and pipelined
    (depth 6) frames/s, device ms and kernels per batch
    (``torch.profiler``), the busy share, peak memory, the bytes of the
    resize's matrix cache and which ``group_rectangles`` route ran.  Then
    the same once at 1080p, batch 16;
12. the reference's flow in small, without OpenCV or a video file: for two
    persons (``bench.haar_face(side, person)``), 24 uint8 BGR 544p frames
    each through ``detect_frames`` (the body of ``detect_video``), the
    crops into a ``train_v2`` model trained on the card and written with
    ``save_model_v2`` into a temporary lock directory; then 16 fresh
    frames through ``scan_frames_haar_multimodel`` with the models read
    back.  Every frame must give one record, its box the planted face's by
    the tolerance above, its name the planted person's, and a
    ``DetectionFile`` must survive ``write_detection_json`` and
    ``read_detection_json``.  It prints the frames/s of both halves.
    Neither phase launches a hand-written kernel (the Haar arithmetic is
    PyTorch's own operators, as it was XLA's in the JAX package), and both
    check that;
13. the CCOEFF detector: ``bench.ccoeff_detect`` (seed 11), 4 uint8 gray
    1080p frames, 2 persons x 10 templates of 100 x 100 (one shape
    group), scales 0.5-1.6, 128 candidates, person 0's clean face planted
    at a seeded place.  Every frame's survivors must hold the planted box
    (x and y within 3 px, 100 x 100); frame 0's resized levels must equal
    the CPU's bit for bit; frame 0's top-k per (scale, group) and its
    survivors must equal the same detector's on the CPU, except for
    candidates within 1e-4 of the largest |score| of the k-th score (the
    gap at rank k is printed per (scale, group)).  It prints frames/s,
    device ms per frame by kernel family (``torch.profiler``), peak memory
    and the seconds of one pass inside ``utils.profiling.device_trace``,
    whose trace file must exist;
14. the enhanced ensemble: ``bench.enhanced_assets`` (seed 12), 2 persons
    x 77 uint8 BGR 1080p frames with a face of a seeded side of 120-220 px,
    their Haar crops (77 per person) into ``train_enhanced`` on the card
    (x 7 augmentation: 1,078 rows, ``n_components`` 100), then 16 of those
    frames, the persons in turn, through ``scan_frames_enhanced``.  Every frame must give
    one record, the planted box and person, at or above its threshold;
    each record's angle must equal the CPU's on the same crop; the model
    copied to the CPU must give the card's ids and confidences within
    1e-5.  Then what the model has not seen: 8 fresh frames through
    ``scan_frames_enhanced`` (a record for each) and 4 whole face patches,
    which the profile cascade takes for profiles.  Their angles on the card
    must equal the CPU's, at least one a profile, and the card's ids and
    confidences the CPU copy's, with no threshold asserted (an id may
    differ only where the confidence is within 1e-5 of its threshold).  ``save_enhanced`` ->
    ``load_enhanced`` must give equal arrays.  It prints the training
    seconds, the scan's frames/s and seconds per stage;
15. the reference's flow, detect -> train -> recognize, without OpenCV:
    ``run_pipeline_frames`` on 48 uint8 BGR 1080p frames of one planted
    person (``bench.pipeline_assets``, seed 13) with a temporary lock
    directory: 48 faces, ``n_components`` 47, a record per frame with the
    planted box and the person's name, and ``evaluate_model`` of the
    trained model on 16 crops of fresh frames at top-1 1.0.  With 16
    crops of another person added (a reject is right), at the PCA gate
    (0.8), ``evaluate_model`` of each crop on the card must equal it on
    the model copied to the CPU: the same id, confidence within 1e-5.  Then
    ``cli.main(["bench", "--streams", "4", "--size", "1080p"])`` with no
    ``--device``, three times: each must print a JSON line whose
    self-check holds, and launch ``fused_match``
    (``launches_by_path["cli_bench"]``); each reading's windows on the host
    clock and by CUDA events are printed, and the spread of both over all
    nine;
16. multi-process meshes on ``torch.distributed``: the script starts
    itself again as workers (``--distributed-worker``), which join a group
    through ``parallel.distributed.initialize_multihost`` and build
    ``global_mesh``.  First one NCCL rank on the card (world size 1):
    ``global_mesh(data=1, model=8)`` over 8 entries of it, then phase 6's
    ``multichip_train_step`` (2048 images of 64², k 128),
    ``sharded_gallery_match`` against the 1,048,573-row gallery in float32
    and bfloat16 (every probe named by its planted label) and
    ``dp_recognize`` of the 1024 crops.  Then two gloo ranks, both
    computing on the one card (NCCL refuses two ranks on one GPU):
    ``global_mesh(data=2, model=4)`` from 4 entries per rank, the train
    step and ``dp_recognize`` of the 1024 crops, and
    ``bench.dryrun_multichip(8, n_hosts=2)``, which must print its two
    lines.  On both meshes each rank also runs the tracker slice (phase
    4's 64 streams of 1080p, 8 frame batches on the NCCL rank and 4 on the
    gloo pair, a model the parent trained): every ``process_batch``
    step, one ``process_window`` and the final origins.  This process's
    one-process meshes of the same shapes give the references, each held
    first: the train step against the dense ``snapshot_pca`` as in phase
    6, the gallery kernel on every shard of the step's gallery (256
    probes, k 128, 256 rows a shard on (1, 8) and 512 on (2, 4)) against
    its plain version, and on shard 0 both against the cosines in float64
    on the card, the shards' bests combined equal to the step's
    confidences, ``dp_recognize`` against ``recognize``, the tracker
    planted-exact, and the fused kernel against plain at the shape each
    gloo rank gives it (B = 32 crops, D = 9216, k 64, N 256; B = 64 on the
    NCCL rank is phase 3's), timed beside plain, ``crops @ m`` and the
    bound (``b32_d9216`` in the JSON line).  Every rank's results must equal the reference of its
    mesh's shape bit for bit, and its kernel launches are counted around
    its main path (``launches_by_path["distributed"]`` for the gallery
    kernel, ``["tracker_distributed"]`` for the fused one, summed over the
    ranks).  A rank that exits nonzero, outlives 300 s or prints no result
    fails the run.  It prints the seconds to join, the ms per call of each
    step, the tracker's ms per frame step, the ms of its gather of a
    step's windows and of ``all_gather_in_rank_order`` of the 1024
    results, and the launches per rank;
17. the end-to-end video loop without OpenCV: ``bench.e2e_frames`` on 160
    uint8 BGR 1080p frames of one planted person
    (``bench.haar_bgr_frames``, seed 17), batch 16, decode, annotation
    and encode left out.  It must train on at least 4 crops, the Haar
    variant must detect in every frame, and the same detector on the
    same gray frames must give each frame's planted face as its largest
    box; then on two batches of 240 x 320 frames the card's training
    crops, detections and recognitions of both variants must equal the
    CPU's (a 1080p Haar frame takes seconds on the CPU).  It prints both
    variants' frames/s.

The line before the last is a JSON object describing each kernel, with
its time, its plain version's, ``library_ms``, its HMMA counts, its
launches by phase (``launches_by_path``; ``launches`` is their sum) and
``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and
its operations over the published dense peak of their type (fp32 67,
TF32 495, bf16 989 TFLOP/s, ``bench.PEAK_FLOPS``; float32 products count
as three TF32 products, the 3xTF32 both kernels run).  For the fused kernel ``ms``,
``plain_ms`` and ``library_device_ms`` are device-only (CUDA graph)
times, and ``event_loop_ms``, ``plain_event_loop_ms`` and ``library_ms``
the event-loop ones; ``b512``, ``d16384``, ``b768_d16384`` and
``b32_d9216`` hold the same at the headline's, the multi-model scan's,
geom256's and the gloo tracker ranks' shapes.
The last line is ``{"ok": true, "device":
{...}}``.  Any failed check raises,
so the script exits nonzero without that line, as it does when PyTorch
sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from face_detection_recognization_pca_tpu_torch import bench, device as port_device
from face_detection_recognization_pca_tpu_torch.config import RecognizeConfig
from face_detection_recognization_pca_tpu_torch.detect import haar
from face_detection_recognization_pca_tpu_torch.detect.template import TemplateDetector
from face_detection_recognization_pca_tpu_torch.io import native
from face_detection_recognization_pca_tpu_torch.io.artifacts import save_model_v1, save_model_v2
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    DetectionFile,
    DetectionRecord,
    read_detection_json,
    write_detection_json,
)
from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta
from face_detection_recognization_pca_tpu_torch.linalg.pca import snapshot_pca
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import (
    PARAM_NAMES,
    EigenfacesModel,
    extract_features,
    from_artifact,
    from_params,
    recognize,
    to_artifact,
    train_v1,
    train_v2,
)
from face_detection_recognization_pca_tpu_torch.ops import _build
from face_detection_recognization_pca_tpu_torch.ops import resize as port_resize
from face_detection_recognization_pca_tpu_torch.ops.fused_match import (
    LinearizedModel,
    _fill16,
    fused_match,
    make_fused_recognizer,
    recognize_linearized,
)
from face_detection_recognization_pca_tpu_torch.ops.gallery_match import (
    _gallery_match_plain,
    gallery_match,
)
from face_detection_recognization_pca_tpu_torch.parallel import (
    all_gather_in_rank_order,
    dp_recognize,
    global_mesh,
    initialize_multihost,
    make_mesh,
    multichip_train_step,
    sharded_gallery_match,
    snapshot_pca_sharded,
)
from face_detection_recognization_pca_tpu_torch.parallel.distributed import GROUP_VARS
from face_detection_recognization_pca_tpu_torch.parallel.multistream import slice_windows
from face_detection_recognization_pca_tpu_torch.parallel.sharding import _gather_chunks
from face_detection_recognization_pca_tpu_torch.ops.preprocess import preprocess_crops
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear
from face_detection_recognization_pca_tpu_torch.pipeline.detect_app import (
    DETECT_BATCH,
    detect_frames,
)
from face_detection_recognization_pca_tpu_torch.pipeline.scan_app import (
    scan_batches_multimodel,
    scan_frames_haar_multimodel,
    scan_frames_multimodel,
)
from face_detection_recognization_pca_tpu_torch.recognize.engine import ModelStack
from face_detection_recognization_pca_tpu_torch.pipeline.tracked_scan import (
    scan_batches_tracked,
)
from face_detection_recognization_pca_tpu_torch.detect.ccoeff import CcoeffTemplateDetector
from face_detection_recognization_pca_tpu_torch.models import enhanced
from face_detection_recognization_pca_tpu_torch.ops.color import bgr_to_gray_exact
from face_detection_recognization_pca_tpu_torch.pipeline import cli
from face_detection_recognization_pca_tpu_torch.pipeline.eval_app import evaluate_model
from face_detection_recognization_pca_tpu_torch.pipeline.run_pipeline import run_pipeline_frames
from face_detection_recognization_pca_tpu_torch.pipeline.scan_app import scan_frames_enhanced
from face_detection_recognization_pca_tpu_torch.utils.profiling import StageTimer, device_trace

CONF_ATOL = 1e-5  # float32 sums in another order than cuBLAS's; cosines ~1
CONF_ATOL_BF16 = 2e-3  # bf16 operands, against plain with the same rounding
NEAR_TIE = 1e-5  # a differing id on random data: plain cosines this close
STREAMS, BATCHES, SEED = 64, 8, 4
HEADLINE_STREAMS, HEADLINE_BATCHES = 16, 32
G256_STREAMS = 24  # bench.headline_geom256's default: 768 windows of 256 x 256 per dispatch
SCAN_FRAMES, SCAN_BATCH, SCAN_SEED, SCAN_PERSON = 256, 16, 7, "planted_person"
DETECT_BATCH, DETECT_TEMPLATES, DETECT_SEED = 16, 8, 3
MULTISCAN_FRAMES, MULTISCAN_BATCH, MULTISCAN_SEED, MULTISCAN_SIDE = 64, 16, 5, 128
HAAR_BATCH, HAAR_SEED = 16, 5  # the JAX package's bench_haar: batch 16, 544p, seed 5
PIPELINE_TRAIN_FRAMES, PIPELINE_SCAN_FRAMES, PIPELINE_K = 24, 16, 16
CCOEFF_BATCH, CCOEFF_SEED, CCOEFF_K = 4, 11, 128
CCOEFF_BAND = 1e-4  # of the largest |score|: a near-tie at rank k
ENHANCED_SCAN, ENHANCED_SEED, ENHANCED_K = 16, 12, 100
FLOW_FRAMES, FLOW_SEED = 48, 13
CLI_BENCH_READINGS = 3
# Phase 17: bench_e2e_video's defaults (160 frames, batch 16) on 1080p
# frames; the card against the CPU on two batches of 240 x 320 frames.
E2E_FRAMES, E2E_BATCH, E2E_SEED, E2E_CPU_SIZE = 160, 16, 17, (240, 320)
GALLERY_B, GALLERY_K, GALLERY_N, GALLERY_SEED = 1024, 128, 1_048_573, 9
JAX_SHAPE_N = 131072  # the JAX package's per-chip target (bench_large_gallery)
TRAIN_N, TRAIN_SIDE, TRAIN_K, TRAIN_SEED = 2048, 64, 128, 6
# multichip_train_step against the dense snapshot_pca, both float32 on the
# card: eigenvalues within 1e-4 of the largest, and the rank-128
# reconstruction proj @ components (well conditioned: component 128 stands
# 13x above the noise, bench.structured_faces) within 1e-3 of its largest.
EIG_RTOL, RECON_RTOL = 1e-4, 1e-3
# Phase 16: each worker pair must end within DIST_TIMEOUT seconds; the
# all_gather of the 1024 results is timed over DIST_GATHER_CALLS calls.
DIST_TIMEOUT, DIST_GATHER_CALLS = 300, 50
DIST_MESHES = {"nccl": (1, 8), "gloo": (2, 4)}  # (data, model) over the ranks' entries
DIST_WORLD = {"nccl": 1, "gloo": 2}
# The tracker slice across processes: phase 4's 64 streams of 1080p, 8
# frame batches on the NCCL rank and 4 on the gloo pair, whose two ranks
# share the card and gather every step's windows through host copies.
DIST_TRACKER_BATCHES = {"nccl": 8, "gloo": 4}
KERNELS = {
    "fused_match": {
        "name": "fused_match",
        "route": "cuda",
        "source": "face_detection_recognization_pca_tpu_torch/csrc/fused_match.cu",
        "replaces": "face_detection_recognization_pca_tpu/ops/pallas_kernels.py:122",
    },
    "gallery_match": {
        "name": "gallery_match",
        "route": "cuda",
        "source": "face_detection_recognization_pca_tpu_torch/csrc/gallery_match.cu",
        "replaces": "face_detection_recognization_pca_tpu/ops/pallas_kernels.py:232",
    },
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least ms the card could take: bytes over HBM's rate or FLOPs over
    the peak of their type, whichever is larger, and which one it is."""
    by_bytes = nbytes / bench.HBM_BYTES_PER_S * 1e3
    by_ops = flops / bench.PEAK_FLOPS[kind] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def gallery_bound(b: int, k: int, n: int, dt: torch.dtype) -> dict:
    """gallery_match on float32 features and an (n, k) gallery in ``dt``:
    each input read once, idx and best written once; 2 b k n products, as
    three TF32 products each for float32 (3xTF32), one bf16 product each
    for bf16."""
    nbytes = b * k * 4 + n * k * (2 if dt == torch.bfloat16 else 4) + n * 4 + b * 8
    if dt == torch.float32:
        return bound(nbytes, 3 * 2.0 * b * k * n, "tf32")
    return bound(nbytes, 2.0 * b * k * n, "bf16")


def card_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_environment() -> torch.device:
    dev = port_device.require_cuda()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    print(card_and_limit())
    torch.set_float32_matmul_precision("highest")
    flags = port_device.disable_tf32()
    print(f"[env] tf32 {flags}")
    check(not any(flags.values()), f"TF32 off: {flags}")
    return dev


def _kernel_label(mangled: str) -> str:
    """A short name for a kernel's mangled symbol: the gallery tile
    kernel's instantiations as ``tiles<dtype,layout,fill>``."""
    m = re.search(r"gallery_match_tilesI(f|13__nv_bfloat16)Lb([01])ELb([01])E", mangled)
    if m:
        return (f"tiles<{'f32' if m[1] == 'f' else 'bf16'},{'rows' if m[2] == '1' else 'k_n'},"
                f"{'cp.async' if m[3] == '1' else 'elements'}>")
    m = re.search(r"fused_match_kernelILb([01])E", mangled)
    if m:
        return f"fused<{'cp.async' if m[1] == '1' else 'elements'}>"
    # _Z<len><name>, or _ZN<len><namespace><len><name> for a kernel in an
    # anonymous namespace.
    m = re.match(r"_ZN(\d+)", mangled)
    at = m.end() + int(m[1]) if m else 2
    m = re.match(r"\d+", mangled[at:])
    return mangled[at + m.end():at + m.end() + int(m[0])] if m else mangled


def _ptxas_counts(log: str) -> dict:
    """Kernel -> its registers and spills, from nvcc's ``-Xptxas -v``."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = _kernel_label(m[1])
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill {m[1]}/{m[2]} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = f"{m[1]} regs, {spill}"
    return out


def _hmma_counts(lib_path) -> tuple:
    """(command, kernel -> HMMA instructions in its SASS) by cuobjdump."""
    cmd = [_build.cuda_tool("cuobjdump"), "--dump-sass", str(lib_path)]
    sass = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = _kernel_label(m[1])
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return cmd, counts


def phase_build() -> dict:
    """kernel name -> {kernel: HMMA count} of each library, checked."""
    # One nvcc per source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))
    seconds = time.perf_counter() - t0
    hmma = {}
    for name in KERNELS:
        lib = _build.library_path(name)
        ptxas = "; ".join(f"{k} {v}" for k, v in
                          _ptxas_counts(lib.with_suffix(".log").read_text()).items())
        print(f"[build] {name}.cu (both in {seconds:.2f} s); ptxas: {ptxas}")
        cmd, hmma[name] = _hmma_counts(lib)
        cmd[0], cmd[-1] = "cuobjdump", str(lib.relative_to(lib.parents[2]))
        print(f"[build] {' '.join(cmd)}: HMMA instructions per kernel {json.dumps(hmma[name])}")
    tiles = {k: v for k, v in hmma["gallery_match"].items() if k.startswith("tiles<")}
    check(len(tiles) == 8 and all(tiles.values()),
          f"every gallery tile kernel runs on the tensor cores: {tiles}")
    fused = hmma["fused_match"]
    check(len(fused) == 2 and all(fused.values()),
          f"every fused_match kernel runs on the tensor cores: {fused}")
    return {"gallery_match": tiles, "fused_match": fused}


def _match_case(dev, gen, b, d, k, n, near, masked=0, tie=None, zero_row=None):
    """Crops near gallery rows ``near`` (a crop per entry), a gallery built
    from their features, the last ``masked`` rows masked with -inf,
    column ``tie[1]`` a copy of column ``tie[0]``, and crop ``zero_row``
    all zero with a zero bias (so its features have norm 0)."""

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    m = randn(d, k, scale=d ** -0.5)
    bias = torch.zeros(k, device=dev) if zero_row is not None else randn(k)
    base = randn(n, d, scale=25.0)
    feats_g = base @ m + bias
    if tie is not None:
        feats_g[tie[1]] = feats_g[tie[0]]
    gallery_t = feats_g.T.contiguous()
    gnorm = torch.linalg.vector_norm(feats_g, dim=1)
    crops = base[torch.tensor(near, device=dev)] + randn(b, d, scale=5.0)
    if zero_row is not None:
        crops[zero_row] = 0.0
    mask = None
    if masked:
        mask = torch.zeros(n, device=dev)
        mask[n - masked:] = float("-inf")
    return crops.contiguous(), m, bias, gallery_t, gnorm, mask


def fused_bound(b: int, d: int, k: int, n: int) -> dict:
    """fused_match at (B, D, k, N): crops, m, bias, gallery_t, gnorm read
    once, ids and conf written once; 2 b d k + 2 b k n products, as three
    TF32 products each (the 3xTF32 the kernel runs)."""
    nbytes = 4 * (b * d + d * k + k + k * n + n + 2 * b)
    return bound(nbytes, 3 * (2.0 * b * d * k + 2.0 * b * k * n), "tf32")


def phase_kernel_vs_plain(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = {
        "slice": _match_case(dev, gen, 64, 96 * 96, 64, 256, near=list(range(0, 256, 4))),
        "ragged_masked": _match_case(dev, gen, 5, 4099, 8, 33, near=[0, 31, 32, 5, 10],
                                     masked=3),
        "tie": _match_case(dev, gen, 4, 576, 16, 40, near=[3, 3, 9, 20], tie=(3, 7)),
        "zero_norm": _match_case(dev, gen, 3, 576, 16, 40, near=[1, 2, 3], zero_row=1),
        "k300": _match_case(dev, gen, 16, 4096, 300, 512, near=list(range(0, 512, 32))),
        "b130": _match_case(dev, gen, 130, 96 * 96, 64, 256, near=[i % 256 for i in range(130)]),
        "k7": _match_case(dev, gen, 9, 2048, 7, 60, near=list(range(0, 60, 7))),
        "b512": _match_case(dev, gen, 512, 96 * 96, 64, 256, near=[i % 256 for i in range(512)]),
        "b1": _match_case(dev, gen, 1, 96 * 96, 64, 256, near=[201]),
    }
    check(not _fill16(*cases["k7"][:2], cases["k7"][3]), "k = 7 takes the element fill")
    check(_fill16(*cases["slice"][:2], cases["slice"][3]), "the slice takes the cp.async fill")
    max_err = 0.0
    for name, (crops, m, bias, gallery_t, gnorm, mask) in cases.items():
        n = gallery_t.shape[1]
        lin = LinearizedModel(m, bias, gallery_t, gnorm,
                              torch.arange(n, dtype=torch.int32, device=dev), (1, crops.shape[1]))
        ids_k, conf_k = fused_match(crops, m, bias, gallery_t, gnorm, mask)
        ids_p, conf_p = recognize_linearized(lin, crops, mask)
        torch.cuda.synchronize()
        err = float((conf_k - conf_p).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] {name}: B={crops.shape[0]} D={crops.shape[1]} k={m.shape[1]} N={n}: "
              f"ids {ids_k.tolist()[:8]} max|dconf| {err:.3g}")
        check(torch.equal(ids_k, ids_p), f"{name}: ids {ids_k.tolist()} vs {ids_p.tolist()}")
        check(err <= CONF_ATOL, f"{name}: conf error {err} > {CONF_ATOL}")
    check(int(fused_match(*cases["tie"])[0][0]) == 3, "tie goes to the first column")
    zero_ids, zero_conf = fused_match(*cases["zero_norm"])
    check(int(zero_ids[1]) == 0 and float(zero_conf[1]) == 0.0, "zero-norm crop scores 0")
    masked_ids = fused_match(*cases["ragged_masked"])[0]
    check(bool((masked_ids < 30).all()), "masked rows never win")
    k300_ids = fused_match(*cases["k300"])[0]
    check(k300_ids.tolist() == list(range(0, 512, 32)), "k = 300 finds every near row")
    check(fused_match(*cases["b130"])[0].tolist() == [i % 256 for i in range(130)],
          "B = 130 finds every near row")
    check(fused_match(*cases["b512"])[0].tolist() == [i % 256 for i in range(512)],
          "B = 512 finds every near row")
    check(fused_match(*cases["b1"])[0].tolist() == [201], "B = 1 finds its near row")

    # The split sums run in a fixed order: two calls give the same bits,
    # and so does a CUDA graph's replay (the counters start from 0 again).
    crops, m, bias, gallery_t, gnorm, _ = cases["slice"]
    first, second = fused_match(crops, m, bias, gallery_t, gnorm), fused_match(
        crops, m, bias, gallery_t, gnorm)
    check(all(torch.equal(a, b) for a, b in zip(first, second)), "a repeat gives the same bits")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_match(crops, m, bias, gallery_t, gnorm)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = fused_match(crops, m, bias, gallery_t, gnorm)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, replayed)),
              "a CUDA-graph replay equals the eager call")
    print("[kernel] slice: two calls and three CUDA-graph replays give the same bits")

    lin = LinearizedModel(m, bias, gallery_t, gnorm,
                          torch.zeros(gallery_t.shape[1], dtype=torch.int32, device=dev),
                          (96, 96))
    fns = {
        "plain": lambda: recognize_linearized(lin, crops),
        "kernel": lambda: fused_match(crops, m, bias, gallery_t, gnorm),
        # The projection alone, a yardstick the port never calls.
        "library": lambda: crops @ m,
    }
    # CUDA events around 200 Python calls (host and card), then around
    # replays of a CUDA graph of 50 calls (the card alone), each taken in
    # the order plain, kernel, library, library, kernel, plain.
    turns = bench.time_in_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"))
    loop, dev_only = turns["loop"], turns["device"]
    prof = {name: bench.profiler_ms(fn, 50) for name, fn in fns.items()}
    (b, d), (k, n) = crops.shape, gallery_t.shape
    bnd = fused_bound(b, d, k, n)
    mean = {clock: {name: sum(v) / len(v) for name, v in t.items()} for clock, t in turns.items()}
    timing = {"ms": mean["device"]["kernel"], "event_loop_ms": mean["loop"]["kernel"],
              "plain_ms": mean["device"]["plain"], "plain_event_loop_ms": mean["loop"]["plain"],
              "library_ms": mean["loop"]["library"],
              "library_device_ms": mean["device"]["library"], "profiler_ms": prof, **bnd,
              "share": bnd["bound_ms"] / mean["device"]["kernel"], "bf16_bound_ms": None}
    fmt = lambda v: "/".join(f"{x:.5f}" for x in v)  # noqa: E731
    print(f"[kernel] slice shape B={b} D={d} k={k} N={n}, ms per call: event loop kernel "
          f"{fmt(loop['kernel'])}, plain {fmt(loop['plain'])}, crops @ m {fmt(loop['library'])}; "
          f"device-only (CUDA graph of 50) kernel {fmt(dev_only['kernel'])}, plain "
          f"{fmt(dev_only['plain'])}, crops @ m {fmt(dev_only['library'])}; torch.profiler "
          f"kernel sums {json.dumps(prof)}; bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), "
          f"share {timing['share']:.3f}")

    # The headline's batch: B = 512 in one launch, eight 64-crop tiles.
    crops, m, bias, gallery_t, gnorm, _ = cases["b512"]
    lin = LinearizedModel(m, bias, gallery_t, gnorm, lin.labels, (96, 96))
    turns = bench.time_in_turns(
        {"plain": lambda: recognize_linearized(lin, crops),
         "kernel": lambda: fused_match(crops, m, bias, gallery_t, gnorm),
         "library": lambda: crops @ m},
        ("plain", "kernel", "library", "library", "kernel", "plain"), loop_iters=50,
        graph_calls=20)
    mean = {clock: {name: sum(v) / len(v) for name, v in t.items()} for clock, t in turns.items()}
    bnd = fused_bound(512, d, k, n)
    b512 = {"ms": mean["device"]["kernel"], "event_loop_ms": mean["loop"]["kernel"],
            "plain_ms": mean["device"]["plain"], "plain_event_loop_ms": mean["loop"]["plain"],
            "library_ms": mean["loop"]["library"], "library_device_ms": mean["device"]["library"],
            **bnd, "share": bnd["bound_ms"] / mean["device"]["kernel"]}
    print(f"[kernel] headline shape B=512 D={d} k={k} N={n}, mean ms per call: "
          f"{json.dumps(b512)}")
    return {"max_abs_err": max_err, **timing, "b512": b512}


def phase_slice(dev, card: str) -> int:
    h, w = bench.SIZES["1080p"]
    t0 = time.perf_counter()
    msr, frames, plants, boxes0, _ = bench.tracker_recognizer(STREAMS, (h, w), BATCHES, SEED,
                                                              dev)
    torch.cuda.synchronize()
    print(f"[slice] assets + training {time.perf_counter() - t0:.2f} s; frames "
          f"{tuple(frames.shape)} {frames.numel() * 4 / 1e9:.2f} GB on {card}")

    fused_match.launches = gallery_match.launches = 0
    state = msr.init_state(STREAMS, (h, w), boxes0)
    outs = []
    for f in range(BATCHES):
        out, state = msr.process_batch(frames[f], state)
        outs.append(out)
    state_b = state
    wout, state_w = msr.process_window(frames, msr.init_state(STREAMS, (h, w), boxes0))
    torch.cuda.synchronize()
    launches = fused_match.launches

    check(launches == 2 * BATCHES, f"fused_match launched {launches} times, want {2 * BATCHES}")
    check(gallery_match.launches == 0, "the tracker does not use the gallery kernel")
    check(bench.planted_exact(outs, plants), "process_batch planted-exact")
    check(bench.planted_exact(wout, plants), "process_window planted-exact")
    check(tuple(wout["confidence"].shape) == (BATCHES, STREAMS), "window result shape")
    for key in ("gallery_row", "person_id", "x", "y"):
        check(wout[key].dtype == torch.int32, f"{key} is int32")
        check(torch.equal(torch.stack([o[key] for o in outs]), wout[key]),
              f"{key}: process_batch == process_window")
    check(torch.equal(state_b.origin, state_w.origin), "final origins agree")
    conf = wout["confidence"]
    tm_conf = wout["template_confidence"]
    check(bool(torch.isfinite(conf).all() and torch.isfinite(tm_conf).all()), "finite scores")
    check(float(conf.min()) > 0.999 and float(tm_conf.min()) > 0.99, "planted face scores ~1")
    check(bool((wout["person_id"] == 0).all()), "person id of gallery row 0")
    print(f"[slice] planted-exact on both paths; fused_match launches {launches}; "
          f"min conf {float(conf.min()):.6f}, min template conf {float(tm_conf.min()):.6f}")
    del msr, frames, outs, wout

    # bench.tracker: its own assets and model, a verified first pass of each
    # path, then process_batch best of 3 passes and process_window best of 3.
    fused_match.launches = 0
    t0 = time.perf_counter()
    result = bench.tracker(STREAMS, "1080p", BATCHES, 3, SEED, device=dev)
    bench_launches = fused_match.launches
    want = (1 + 3) * BATCHES * 2
    print(f"[slice] bench.tracker: {json.dumps(result)}; fused_match launches {bench_launches}; "
          f"{time.perf_counter() - t0:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    check(result["tracker_planted_pos_exact"] and result["tracker_planted_id_exact"]
          and result["tracker_window_planted_exact"], "bench.tracker planted-exact")
    check(result["tracker_fps"] > 0 and result["tracker_window_fps"] > 0,
          "bench.tracker published both fps")
    check(bench_launches == want, f"bench.tracker launched fused_match {bench_launches}, "
          f"want {want}")
    return launches + bench_launches


def _plain_cos(feats, gallery_t, gnorm, rows, dt):
    """The plain version's cosine of each feature row b with gallery row
    rows[b], its operands rounded to ``dt``."""
    f = feats.to(dt).float()
    g = gallery_t.to(dt).float()[:, rows.long()].T
    fnorm = torch.linalg.vector_norm(feats.float(), dim=1)
    gn = gnorm[rows.long()]
    return (f * g).sum(1) * torch.where(fnorm > 0, 1 / fnorm, 0.0) * torch.where(
        gn > 0, 1 / gn, 0.0)


def _gallery_cases(dev, gen):
    """name -> (feats, gallery_t, gnorm, dtype, random): feature rows, a
    (k, N) gallery (a ``.T`` view of (N, k) rows or a contiguous (k, N)),
    its norms with -1 on invalid rows, the operand dtype, and whether the
    data are random (near-ties allowed)."""

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def norms(g):
        return torch.linalg.vector_norm(g.float(), dim=1)

    cases = {}
    feats, gallery = randn(GALLERY_B, GALLERY_K), randn(JAX_SHAPE_N, GALLERY_K)
    cases["jax_shape_f32"] = (feats, gallery.T, norms(gallery), torch.float32, True)
    g16 = gallery.to(torch.bfloat16)
    cases["jax_shape_bf16"] = (feats, g16.T, norms(g16), torch.bfloat16, True)
    feats, gallery = randn(5, 100), randn(1037, 100)
    cases["ragged_rows"] = (feats, gallery.T, norms(gallery), torch.float32, True)
    cases["ragged_k_n"] = (feats, gallery.T.contiguous(), norms(gallery), torch.float32, True)
    cases["ragged_bf16"] = (feats, gallery.T, norms(gallery), torch.bfloat16, True)

    feats, gallery = randn(8, 64), randn(1000, 64)
    gallery[300] = feats[1]
    gallery[700] = feats[0]  # an exact match in an invalid row
    gn = norms(gallery)
    gn[700] = -1.0
    gn[900:] = -1.0
    cases["sentinel"] = (feats, gallery.T, gn, torch.float32, False)

    gallery, feats = randn(1000, 64).abs(), -randn(8, 64).abs()
    gallery[[0, 130, 260, 390]] = 0.0  # invalid zero rows in four tiles
    gn = norms(gallery)
    gn[[0, 130, 260, 390]] = -1.0
    cases["all_negative"] = (feats, gallery.T, gn, torch.float32, False)
    feats = feats.clone()
    feats[2] = 0.0
    cases["zero_feature"] = (feats, gallery.T, gn, torch.float32, False)
    gallery = gallery.clone()
    gallery[517] = 0.0
    gn = norms(gallery)
    gn[[0, 130, 260, 390]] = -1.0
    cases["zero_row"] = (feats, gallery.T, gn, torch.float32, False)

    feats, gallery = randn(4, 64), randn(1000, 64)
    gallery[5], gallery[900] = feats[0] * 2.0, feats[0] * 4.0  # the same cosine
    gallery[77] = gallery[333] = feats[1]
    cases["tie"] = (feats, gallery.T, norms(gallery), torch.float32, False)
    return cases


def hold_gallery_kernel(tag, name, feats, gallery_t, gnorm, dt, random) -> tuple:
    """``gallery_match`` against ``_gallery_match_plain`` on one case: ids
    equal (where ``random``, a differing id must be a near-tie, plain
    cosines within ``NEAR_TIE``), best within the dtype's tolerance.
    Prints a line under ``tag``; returns the kernel's ``(idx, best)`` and
    the largest best error."""
    idx_k, best_k = gallery_match(feats, gallery_t, gnorm, operand_dtype=dt)
    idx_p, best_p = _gallery_match_plain(feats, gallery_t, gnorm, operand_dtype=dt)
    torch.cuda.synchronize()
    differ = (idx_k != idx_p).nonzero()[:, 0]
    gap = 0.0
    if len(differ):
        check(random, f"{name}: ids differ at {differ.tolist()[:8]}")
        cos_k = _plain_cos(feats[differ], gallery_t, gnorm, idx_k[differ], dt)
        cos_p = _plain_cos(feats[differ], gallery_t, gnorm, idx_p[differ], dt)
        gap = float((cos_k - cos_p).abs().max())
        check(gap <= NEAR_TIE, f"{name}: differing ids are no near-ties (gap {gap})")
    err = float((best_k - best_p).abs().max())
    atol = CONF_ATOL if dt == torch.float32 else CONF_ATOL_BF16
    print(f"[{tag}] {name}: B={feats.shape[0]} k={feats.shape[1]} "
          f"N={gallery_t.shape[1]} {str(dt)[6:]}: {len(differ)} near-tie ids "
          f"(max cos gap {gap:.3g}), max|dbest| {err:.3g}")
    check(err <= atol, f"{name}: best error {err} > {atol}")
    return idx_k, best_k, err


def phase_gallery_vs_plain(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = _gallery_cases(dev, gen)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    results = {}
    for name, case in cases.items():
        idx_k, best_k, err = hold_gallery_kernel("gallery", name, *case)
        results[name] = (idx_k, best_k)
        errs[case[3]] = max(errs[case[3]], err)

    idx, best = results["sentinel"]
    check(int(idx[1]) == 300 and int(idx[0]) != 700 and bool((idx < 900).all()),
          "sentinel rows lose, a planted valid row wins")
    idx, best = results["all_negative"]
    check(bool((best < 0).all()) and not bool(torch.isin(idx, torch.tensor(
        [0, 130, 260, 390], device=dev)).any()), "all-negative cosines pick valid rows")
    idx, best = results["zero_feature"]
    check(int(idx[2]) == 1 and float(best[2]) == 0.0, "a zero-norm feature scores 0")
    idx, best = results["zero_row"]
    check(bool((idx[[0, 1, 3]] == 517).all()) and bool((best == 0.0).all()),
          "a valid zero-norm row scores 0")
    idx, _ = results["tie"]
    check(int(idx[0]) == 5 and int(idx[1]) == 77, "ties across tiles go to the first row")

    timing = bench.large_gallery(GALLERY_B, GALLERY_K, JAX_SHAPE_N, iters=10, seed=GALLERY_SEED,
                                 device=dev)
    print(f"[gallery] bench.large_gallery: {json.dumps(timing)}")
    for name in ("f32", "bf16"):
        check(timing[f"{name}_planted"] == 1.0, f"{name}: every planted row found")

    # The same operands' product alone by torch.matmul: a yardstick of
    # scale, which the port never calls.
    feats, gallery, _, _ = bench.large_gallery_assets(GALLERY_B, GALLERY_K, JAX_SHAPE_N,
                                                      GALLERY_SEED, dev)
    out = {"max_abs_err": errs[torch.float32], "bf16_max_abs_err": errs[torch.bfloat16]}
    for name, dt, pre in (("f32", torch.float32, ""), ("bf16", torch.bfloat16, "bf16_")):
        f, g = feats.to(dt), gallery.to(dt)
        lib = bench.cuda_time_ms(lambda: torch.matmul(f, g.T), 10)
        bnd = gallery_bound(GALLERY_B, GALLERY_K, JAX_SHAPE_N, dt)
        ms = timing[f"{name}_kernel_ms"]
        out.update({f"{pre}ms": ms, f"{pre}plain_ms": timing[f"{name}_plain_ms"],
                    f"{pre}library_ms": lib, f"{pre}bound_ms": bnd["bound_ms"],
                    f"{pre}share": bnd["bound_ms"] / ms})
        if dt == torch.float32:
            out["bound_by"] = bnd["bound_by"]
        print(f"[gallery] N={JAX_SHAPE_N} {name}: kernel {ms:.4f} ms, torch.matmul {lib:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), share "
              f"{bnd['bound_ms'] / ms:.3f}")
    return out


def _best_time(fn, reps=3) -> float:
    """Best host-clock seconds of ``reps`` synchronised calls."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _dp_model_and_crops(images: torch.Tensor) -> tuple:
    """A v1 model of ``images`` (labels ``row % 16``) and noisy copies of
    its first ``GALLERY_B`` images as crops, for ``dp_recognize``."""
    model, _ = train_v1(images, n_components=TRAIN_K)
    model.labels = torch.arange(TRAIN_N, dtype=torch.int32, device=images.device) % 16
    noise = torch.Generator(device=images.device).manual_seed(TRAIN_SEED)
    crops = images[:GALLERY_B] + 2 * torch.randn(GALLERY_B, TRAIN_SIDE ** 2, generator=noise,
                                                 device=images.device)
    return model, crops.reshape(-1, TRAIN_SIDE, TRAIN_SIDE)


def check_train_step(tag, m, mesh, step, images, dense) -> None:
    """``multichip_train_step``'s ``(ids, conf, eigval)`` on ``mesh``
    against the dense ``snapshot_pca``: every probe self-matches above
    0.999, the eigenvalues descend and lie within ``EIG_RTOL`` of the
    dense ones, and the mesh's rank-k reconstruction within
    ``RECON_RTOL``."""
    ids, conf, eigval = step
    recon_d = dense.projected @ dense.components
    comps, _, proj, _ = snapshot_pca_sharded(mesh, images, TRAIN_K)
    eig_err = float((eigval - dense.eigenvalues).abs().max() / dense.eigenvalues[0])
    recon_err = float((proj @ comps - recon_d).abs().max()) / float(recon_d.abs().max())
    print(f"[{tag}] multichip_train_step {m}: ids {sorted(set(ids.tolist()))}, min conf "
          f"{float(conf.min()):.6f}, eigenvalue err {eig_err:.3g} of the largest, "
          f"reconstruction err {recon_err:.3g} of its largest")
    check(bool((ids == 0).all()) and float(conf.min()) > 0.999, f"{m}: probes self-match")
    check(bool((eigval[1:] <= eigval[:-1]).all()), f"{m}: eigenvalues descending")
    check(eig_err <= EIG_RTOL, f"{m}: eigenvalues vs dense {eig_err}")
    check(recon_err <= RECON_RTOL, f"{m}: reconstruction vs dense {recon_err}")


def phase_gallery_slice(dev, card: str) -> tuple:
    t0 = time.perf_counter()
    feats, gallery, labels, planted = bench.large_gallery_assets(
        GALLERY_B, GALLERY_K, GALLERY_N, GALLERY_SEED, dev)
    want = labels[torch.from_numpy(planted).to(dev)]
    galleries = {torch.float32: gallery, torch.bfloat16: gallery.to(torch.bfloat16)}
    images = bench.structured_faces(TRAIN_N, TRAIN_SIDE, TRAIN_K, TRAIN_SEED, dev)
    model, crops = _dp_model_and_crops(images)
    probes = images[:256].reshape(-1, TRAIN_SIDE, TRAIN_SIDE)
    meshes = {"(1,1)": make_mesh(1, 1), "(1,8)": make_mesh(1, 8, devices=[dev] * 8)}
    dp_mesh = make_mesh(8, 1, devices=[dev] * 8)
    torch.cuda.synchronize()
    print(f"[slice2] assets + training {time.perf_counter() - t0:.2f} s; gallery "
          f"{tuple(gallery.shape)} {gallery.numel() * 4 / 1e9:.2f} GB on {card}")

    def match(mesh, dt):
        return sharded_gallery_match(meshes[mesh], feats, galleries[dt], labels)

    def train(mesh):
        return multichip_train_step(meshes[mesh], images, probes, TRAIN_K,
                                    (TRAIN_SIDE, TRAIN_SIDE))

    fused_match.launches = gallery_match.launches = 0
    matched = {(m, dt): match(m, dt) for dt in galleries for m in meshes}
    dp = dp_recognize(dp_mesh, model, crops)
    trained = {m: train(m) for m in meshes}
    torch.cuda.synchronize()
    launches = gallery_match.launches
    want_launches = 3 * sum(mesh.shape["model"] for mesh in meshes.values())
    check(launches == want_launches, f"gallery_match launched {launches}, want {want_launches}")
    check(fused_match.launches == 0, "this slice does not use the fused kernel")

    for dt, g in galleries.items():
        gn = torch.linalg.vector_norm(g, dim=1, dtype=torch.float32)
        ref_idx, ref_best = _gallery_match_plain(feats, g.T, gn, operand_dtype=dt)
        ref_ids = labels[ref_idx.long()]
        atol = CONF_ATOL if dt == torch.float32 else CONF_ATOL_BF16
        for m in meshes:
            ids, conf = matched[(m, dt)]
            err = float((conf - ref_best).abs().max())
            print(f"[slice2] sharded_gallery_match {m} {str(dt)[6:]}: min conf "
                  f"{float(conf.min()):.6f}, max|dconf| vs dense plain {err:.3g}")
            check(torch.equal(ids, want), f"{m} {dt}: every probe named by its planted label")
            check(torch.equal(ids, ref_ids), f"{m} {dt}: ids equal the dense plain reference")
            check(err <= atol, f"{m} {dt}: conf error {err} > {atol}")
        check(torch.equal(matched[("(1,1)", dt)][0], matched[("(1,8)", dt)][0]),
              f"{dt}: both meshes agree")
        del ref_idx, ref_best

    ids_s, conf_s = recognize(model, crops)
    err = float((dp[1] - conf_s).abs().max())
    check(torch.equal(dp[0], ids_s), "dp_recognize ids equal recognize's")
    check(err <= CONF_ATOL, f"dp_recognize conf error {err}")
    check(bool((ids_s == model.labels[:GALLERY_B]).all()), "noisy crops name their images")
    print(f"[slice2] dp_recognize (8,1) vs recognize, {GALLERY_B} crops: ids equal, "
          f"max|dconf| {err:.3g}")

    dense = snapshot_pca(images, TRAIN_K)
    for m, step in trained.items():
        check_train_step("slice2", m, meshes[m], step, images, dense)
    check(torch.equal(trained["(1,1)"][0], trained["(1,8)"][0]), "train step: meshes agree")

    # Kernel, plain and torch.matmul of the same operands at N = 1,048,573
    # on one shard, beside the card's bound.
    n1m = {}
    for dt, g in galleries.items():
        gn = torch.linalg.vector_norm(g, dim=1, dtype=torch.float32)
        f = feats.to(dt)
        fns = (lambda: _gallery_match_plain(feats, g.T, gn, operand_dtype=dt),
               lambda: gallery_match(feats, g.T, gn, operand_dtype=dt),
               lambda: torch.matmul(f, g.T))
        p1, k1, l1, l2, k2, p2 = (bench.cuda_time_ms(fns[i], 5, 2) for i in (0, 1, 2, 2, 1, 0))
        bnd = gallery_bound(GALLERY_B, GALLERY_K, GALLERY_N, dt)
        ms = (k1 + k2) / 2
        n1m[str(dt)[6:]] = {"kernel_ms": ms, "plain_ms": (p1 + p2) / 2,
                            "library_ms": (l1 + l2) / 2, **bnd, "share": bnd["bound_ms"] / ms}
    print(f"[slice2] N={GALLERY_N} B={GALLERY_B} k={GALLERY_K} CUDA-event ms per call "
          f"(plain, kernel, matmul, matmul, kernel, plain): {json.dumps(n1m)}; card {card}")

    # Step time per path, for information: host clock, best of 3.
    times = {f"sharded {m} {str(dt)[6:]}": _best_time(lambda: match(m, dt))
             for dt in galleries for m in meshes}
    times["dp_recognize (8,1)"] = _best_time(lambda: dp_recognize(dp_mesh, model, crops))
    times.update({f"multichip_train_step {m}": _best_time(lambda: train(m)) for m in meshes})
    print(f"[slice2] step ms (best of 3): "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
          + f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    return launches, n1m


def phase_headline(dev, card: str) -> tuple:
    """Phase 7; returns the fused kernel's launches in the headline and in
    geom256, and its times at geom256's shape."""
    fused_match.launches = gallery_match.launches = 0
    t0 = time.perf_counter()
    result = bench.headline(streams=HEADLINE_STREAMS, t_frames=HEADLINE_BATCHES, device=dev)
    launches = fused_match.launches
    detail = result["detail"]
    print(f"[headline] {result['metric']}: {result['value']} {result['unit']}; self-check "
          f"{detail['self_check']} (planted offsets exact {detail['planted_offset_exact']}, "
          f"gallery row 0 {detail['planted_id_rate']}) over {detail['frames_per_dispatch']} "
          f"frames per dispatch; step {detail['step_ms']} ms (host clock, best of 3 windows of "
          f"20 dispatches: {detail['window_step_ms']} ms; CUDA events around the same windows: "
          f"{detail['event_step_ms']} ms); device {detail['device_ms']} ms in "
          f"{detail['kernel_launches']} kernels per dispatch (torch.profiler), busy share "
          f"{detail['busy_share']}; {detail['headline_tflops']} TFLOP/s by the closed form of "
          f"{detail['headline_mflops_per_frame']} MFLOP per frame, "
          f"{detail['headline_tflops_pct']}% of the float32 peak; fused_match launches "
          f"{launches}; PCA train 969x4096 k=100 {detail['pca_train_wall_s_969x4096_k100']} s; "
          f"min conf {detail['min_pca_conf']}, min template conf {detail['min_tm_conf']}; "
          f"phase {time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    check(detail["self_check"] == "ok" and result["value"] > 0,
          f"headline self-check: {detail['self_check']}")
    check(detail["frames_per_dispatch"] == HEADLINE_STREAMS * HEADLINE_BATCHES,
          "the headline ran at its full batch")
    check(launches >= 1 and launches == detail["fused_match_launches"],
          f"the headline launched fused_match {launches} times")
    check(gallery_match.launches == 0, "the headline does not use the gallery kernel")
    check(detail["device_ms"] is not None, "torch.profiler saw the headline's kernels")
    check(len(detail["window_step_ms"]) == len(detail["event_step_ms"]) == 3,
          "the headline reports every window on both clocks")
    torch.cuda.empty_cache()

    # Window 256, template 128: 24 streams x 32 frame batches, one
    # fused_match launch at B = 768, D = 16384 per dispatch.
    fused_match.launches = 0
    t0 = time.perf_counter()
    g256 = bench.headline_geom256(device=dev)
    g256_launches = fused_match.launches
    print(f"[headline] geom256 (window 256, template 128, {G256_STREAMS} streams x 32 frame "
          f"batches of 1080p): {json.dumps(g256)}; fused_match launches {g256_launches}; "
          f"phase part {time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    check(g256["g256_self_check"] == "ok" and g256["g256_fps"] > 0,
          f"geom256 self-check: {g256['g256_self_check']}")
    check(g256_launches >= 1, "geom256 launched fused_match")
    torch.cuda.empty_cache()
    return launches, g256_launches, hold_fused_at(dev, G256_STREAMS * 32, 128 * 128, "geom256")


def hold_fused_at(dev, b: int, d: int, tag: str) -> dict:
    """``fused_match`` against ``recognize_linearized`` at B = ``b``, D =
    ``d``, k 64, N 256 (crops near rows ``i % 256``): ids equal, conf within
    ``CONF_ATOL``; then kernel, plain and ``crops @ m`` timed in turns as in
    phase 3, beside the bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    crops, m, bias, gallery_t, gnorm, _ = _match_case(dev, gen, b, d, 64, 256,
                                                      near=[i % 256 for i in range(b)])
    lin = LinearizedModel(m, bias, gallery_t, gnorm,
                          torch.zeros(256, dtype=torch.int32, device=dev), (1, d))
    ids_k, conf_k = fused_match(crops, m, bias, gallery_t, gnorm)
    ids_p, conf_p = recognize_linearized(lin, crops)
    torch.cuda.synchronize()
    err = float((conf_k - conf_p).abs().max())
    check(torch.equal(ids_k, ids_p), f"{tag}: fused_match ids equal plain's at B={b} D={d}")
    check(ids_k.tolist() == [i % 256 for i in range(b)], f"{tag}: every crop finds its row")
    check(err <= CONF_ATOL, f"{tag}: conf error {err} > {CONF_ATOL}")
    turns = bench.time_in_turns(
        {"plain": lambda: recognize_linearized(lin, crops),
         "kernel": lambda: fused_match(crops, m, bias, gallery_t, gnorm),
         "library": lambda: crops @ m},
        ("plain", "kernel", "library", "library", "kernel", "plain"), loop_iters=50,
        graph_calls=20)
    mean = {clock: {name: sum(v) / len(v) for name, v in t.items()} for clock, t in turns.items()}
    bnd = fused_bound(b, d, 64, 256)
    out = {"max_abs_err": err, "ms": mean["device"]["kernel"],
           "event_loop_ms": mean["loop"]["kernel"], "plain_ms": mean["device"]["plain"],
           "plain_event_loop_ms": mean["loop"]["plain"], "library_ms": mean["loop"]["library"],
           "library_device_ms": mean["device"]["library"], **bnd,
           "share": bnd["bound_ms"] / mean["device"]["kernel"]}
    print(f"[kernel] {tag} shape B={b} D={d} k=64 N=256: ids equal plain's, max|dconf| "
          f"{err:.3g}; mean ms per call {json.dumps(out)}")
    return out


def phase_scan(dev, card: str) -> int:
    h, w = bench.SIZES["1080p"]
    t0 = time.perf_counter()
    frames, gallery_images, face, plants = bench.scan_assets(SCAN_FRAMES, (h, w), SCAN_SEED)
    model, aux = train_v1(torch.from_numpy(gallery_images).to(dev),
                          n_components=bench.N_COMPONENTS)
    print(f"[scan] {SCAN_FRAMES} uint8 frames {frames.shape[1:]} on the host and a model "
          f"trained on the card in {time.perf_counter() - t0:.2f} s; cv2 importable here: "
          f"{importlib.util.find_spec('cv2') is not None} (not needed)")
    y0, x0 = (int(v) for v in plants[0])
    side = face.shape[0]
    prior = DetectionRecord(
        face_id=0, frame_number=0, timestamp=0.0, x=x0, y=y0, width=side, height=side,
        center_x=x0 + side // 2, center_y=y0 + side // 2, area=side * side,
        image_path="face_0_frame_0.jpg", image_filename="face_0_frame_0.jpg")
    clock = {}

    def batches():
        clock["first"] = time.perf_counter()
        for i in range(0, SCAN_FRAMES, SCAN_BATCH):
            yield frames[i:i + SCAN_BATCH], SCAN_BATCH

    with tempfile.TemporaryDirectory() as lock_dir:
        person_dir = os.path.join(lock_dir, SCAN_PERSON)
        os.makedirs(person_dir)
        save_model_v1(to_artifact(model, aux, person_name=SCAN_PERSON),
                      os.path.join(person_dir, "face_model.pkl"))
        write_detection_json(
            DetectionFile("synthetic", SCAN_FRAMES, 30.0, 1, "", [prior]),
            os.path.join(person_dir, f"{SCAN_PERSON}_faces_detection.json"))
        fused_match.launches = gallery_match.launches = 0
        t0 = time.perf_counter()
        records = scan_batches_tracked(
            batches(), VideoMeta(w, h, 30.0, SCAN_FRAMES), SCAN_PERSON, lock_dir=lock_dir,
            device=dev, template_full=face)
        t1 = time.perf_counter()
    launches = fused_match.launches

    check(len(records) == SCAN_FRAMES, f"{len(records)} records for {SCAN_FRAMES} frames")
    got = np.array([(r["y"], r["x"]) for r in records])
    check(np.array_equal(got, plants), "every record holds the planted position")
    check(all(r["person_id"] == 0 and r["person_name"] == SCAN_PERSON for r in records),
          "every record names the enrolled person")
    check([r["frame_number"] for r in records] == list(range(SCAN_FRAMES)), "frame numbers")
    check(all(r["width"] == side and r["height"] == side for r in records), "box sizes")
    conf = min(r["confidence"] for r in records)
    tm_conf = min(r["template_match_confidence"] for r in records)
    check(conf > 0.999 and tm_conf > 0.99, f"planted face scores ~1: {conf}, {tm_conf}")
    check(launches == SCAN_FRAMES, f"fused_match launched {launches} times, want {SCAN_FRAMES}")
    check(gallery_match.launches == 0, "the scan does not use the gallery kernel")
    print(f"[scan] planted-exact over {SCAN_FRAMES} frames in batches of {SCAN_BATCH}; "
          f"fused_match launches {launches}; min conf {conf:.6f}, min template conf "
          f"{tm_conf:.6f}; {SCAN_FRAMES / (t1 - clock['first'])} frames/s from the first batch "
          f"to the last record, {SCAN_FRAMES / (t1 - t0)} frames/s with the model load and the "
          f"tracker's set-up (host clock; the host-to-device copy of every uint8 batch is "
          f"inside both; no decoder runs); card {card}")
    return launches


def phase_detect(dev, card: str) -> None:
    for size in ("544p", "1080p"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = bench.full_frame_detect(DETECT_BATCH, bench.SIZES[size], DETECT_TEMPLATES,
                                         iters=5, seed=DETECT_SEED, device=dev)
        y, x = result["plant"]
        threshold = result["template_threshold"]
        for i, dets in enumerate(result["detections"]):
            check(len(dets) == 1, f"{size} frame {i}: {len(dets)} detections after NMS")
            d = dets[0]
            check((d.x, d.y, d.width, d.height) == (x, y, 128, 128),
                  f"{size} frame {i}: box {(d.x, d.y, d.width, d.height)}, planted {(x, y)}")
            check(d.confidence > threshold, f"{size} frame {i}: confidence {d.confidence}")
        first = result["detections"][0][0]
        parity = result["parity"]
        check(len(parity) == 1 and (parity[0].x, parity[0].y, parity[0].width, parity[0].height)
              == (first.x, first.y, first.width, first.height),
              f"{size}: detect_parity names {parity}, detect_fused {first}")

        # Device time per batch by kernel family, and the resize alone (it
        # shares the matmul kernels with the banded window sums), on the
        # same assets built once more.
        frames, bank, _ = bench.full_frame_assets(DETECT_BATCH, bench.SIZES[size],
                                                  DETECT_TEMPLATES, DETECT_SEED, dev)
        det = TemplateDetector(bank)
        meta, _ = det.detect_fused_device(frames)
        rows = bench.traced_kernels(lambda: det.detect_fused_device(frames), 3)
        check(bool(rows), f"{size}: torch.profiler saw the detector's kernels")
        families = bench.kernel_families(rows)

        def resize_all():
            with port_device.exact_float32():
                for m in meta:
                    resize_bilinear(frames, (m.rw, m.rh))

        resize_ms = bench.cuda_time_ms(resize_all, 5, 2)
        families["matmul_resize"] = resize_ms
        families["matmul_banded_sums"] = families.pop("matmul", 0.0) - resize_ms
        top = [(name[:60], round(us / 1e3, 3)) for name, us, _ in rows[:6]]
        print(f"[detect] {size} batch {DETECT_BATCH}, {DETECT_TEMPLATES} templates x "
              f"{len(meta)} scales: one detection per frame at the planted box "
              f"({x}, {y}, 128, 128), confidence {first.confidence:.6f}, parity confidence "
              f"{parity[0].confidence:.6f}; end to end {result['fps']} frames/s "
              f"({result['ms_per_batch']} ms per batch, best of 5), device half alone "
              f"{result['device_fps']} frames/s ({result['device_ms_per_batch']} ms per batch, "
              f"5 queued back to back); device ms per batch by kernel family (torch.profiler, "
              f"resize by CUDA events) {json.dumps(families)} in "
              f"{sum(c for _, _, c in rows):.0f} kernels, sum "
              f"{sum(us for _, us, _ in rows) / 1e3:.3f} ms; longest kernels {top}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase "
              f"{time.perf_counter() - t0:.2f} s; card {card}")
        del result, det, frames, bank, meta
        torch.cuda.empty_cache()


def _same_scan_records(got, ref) -> bool:
    """Equal ints and names, floats within ``CONF_ATOL``."""
    if len(got) != len(ref):
        return False
    for a, b in zip(got, ref):
        for key, value in a.items():
            if isinstance(value, float):
                if abs(value - b[key]) > CONF_ATOL:
                    return False
            elif value != b[key]:
                return False
    return True


def phase_multiscan(dev, card: str) -> tuple:
    h, w = bench.SIZES["1080p"]
    side = MULTISCAN_SIDE
    t0 = time.perf_counter()
    frames, stack, bank, plants, names, models = bench.multimodel_scan_assets(
        MULTISCAN_FRAMES, (h, w), MULTISCAN_SEED, dev, side=side)
    print(f"[multiscan] {MULTISCAN_FRAMES} uint8 BGR frames {frames.shape[1:]} on the host "
          f"({frames.nbytes / 1e6:.0f} MB), {len(names)} v2 models (k {stack.components.shape[1]}, "
          f"{stack.gallery.shape[1]} rows) and {len(bank.entries)} templates on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    def batches():
        for i in range(0, MULTISCAN_FRAMES, MULTISCAN_BATCH):
            yield frames[i:i + MULTISCAN_BATCH]

    scan_batches_multimodel([frames[:MULTISCAN_BATCH]], stack, bank)  # warm-up: masks, FFT plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = scan_batches_multimodel(batches(), stack, bank)
    seconds = time.perf_counter() - t0
    timings = {}
    timed = scan_batches_multimodel(batches(), stack, bank, timings=timings)
    t0 = time.perf_counter()
    per_frame = scan_frames_multimodel(iter(frames), stack, bank)
    per_frame_seconds = time.perf_counter() - t0

    check([r["frame_number"] for r in records] == list(range(MULTISCAN_FRAMES)),
          f"one record per frame: {[r['frame_number'] for r in records]}")
    for r, (y, x) in zip(records, plants):
        i = r["frame_number"]
        check((r["x"], r["y"], r["width"], r["height"]) == (x, y, side, side),
              f"frame {i}: box {(r['x'], r['y'], r['width'], r['height'])}, planted {(x, y)}")
        check(r["person_name"] == names[i % len(names)], f"frame {i}: named {r['person_name']}")
        check(r["template_confidence"] > 0.7 and r["pca_confidence"] > 0.8,
              f"frame {i}: template {r['template_confidence']}, pca {r['pca_confidence']}")
    check(_same_scan_records(timed, records), "a timed run gives the same records")
    check(_same_scan_records(per_frame, records), "the per-frame scan gives the same records")
    print(f"[multiscan] one record per frame with the planted box and person over "
          f"{MULTISCAN_FRAMES} frames in batches of {MULTISCAN_BATCH}, equal to the per-frame "
          f"scan's; min template confidence {min(r['template_confidence'] for r in records):.6f}, "
          f"min pca confidence {min(r['pca_confidence'] for r in records):.6f}; "
          f"{MULTISCAN_FRAMES / seconds} frames/s batched with the host-to-device copy of every "
          f"batch inside ({seconds / (MULTISCAN_FRAMES / MULTISCAN_BATCH) * 1e3} ms per batch, "
          f"host clock), {MULTISCAN_FRAMES / per_frame_seconds} frames/s per frame; seconds per "
          f"stage over the run, the card waited for after each: {json.dumps(timings)}; card "
          f"{card}")

    # The admitted crops of each person through the fused recognizer of that
    # person's model: D = 128 * 128 = 16384, a shape no earlier path gives.
    grays = torch.stack([
        torch.from_numpy(frames[i, y:y + side, x:x + side, 0].copy())
        for i, (y, x) in enumerate(plants)
    ]).to(dev).to(torch.float32)
    fused_match.launches = gallery_match.launches = 0
    results = []
    for p, model in enumerate(models):
        fn, lin = make_fused_recognizer(model, (side, side))
        results.append((lin, grays[p::len(models)], *fn(grays[p::len(models)])))
    launches = fused_match.launches
    check(launches == len(models), f"fused_match launched {launches} times, want {len(models)}")
    check(gallery_match.launches == 0, "the scan does not use the gallery kernel")
    max_err = 0.0
    for p, (lin, crops, rows, conf) in enumerate(results):
        rows_p, conf_p = recognize_linearized(lin, crops)
        err = float((conf - conf_p).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(rows, rows_p), f"person {p}: rows {rows.tolist()} vs {rows_p.tolist()}")
        check(err <= CONF_ATOL, f"person {p}: conf error {err} > {CONF_ATOL}")
        check(bool((rows == 0).all()) and float(conf.min()) > 0.999,
              f"person {p}: the planted crop is gallery row 0: {rows.tolist()}, {conf.tolist()}")
    lin, _, _, _ = results[0]
    flat = grays.reshape(len(grays), -1).contiguous()
    turns = bench.time_in_turns(
        {"plain": lambda: recognize_linearized(lin, grays),
         "kernel": lambda: fused_match(flat, lin.m, lin.bias, lin.gallery_t, lin.gallery_norm),
         "library": lambda: flat @ lin.m},
        ("plain", "kernel", "library", "library", "kernel", "plain"), loop_iters=50,
        graph_calls=20)
    mean = {clock: {name: sum(v) / len(v) for name, v in t.items()} for clock, t in turns.items()}
    (b, d), (k, n) = flat.shape, lin.gallery_t.shape
    bnd = fused_bound(b, d, k, n)
    d16384 = {"shape": f"B={b} D={d} k={k} N={n}", "max_abs_err": max_err,
              "ms": mean["device"]["kernel"], "event_loop_ms": mean["loop"]["kernel"],
              "plain_ms": mean["device"]["plain"], "plain_event_loop_ms": mean["loop"]["plain"],
              "library_ms": mean["loop"]["library"], "library_device_ms": mean["device"]["library"],
              **bnd, "share": bnd["bound_ms"] / mean["device"]["kernel"]}
    print(f"[multiscan] make_fused_recognizer at (128, 128): {launches} launches, rows equal to "
          f"recognize_linearized's, max|dconf| {max_err:.3g}; mean ms per call at "
          f"{json.dumps(d16384)}; card {card}")
    return launches, d16384


def numpy_cascade_accepts(gray: np.ndarray, cascade, step: int) -> set:
    """The ``(x, y)`` of the windows of one pyramid level that pass every
    stage: the cascade in float64 numpy, every window through every stage
    (window norm ``nf = sqrt(area * sqsum - sum^2)`` over the inner 22 x 22,
    stump test ``rectsum < t * nf``, per-stage sum thresholds)."""
    f = np.asarray(gray, dtype=np.float64)
    h, w = f.shape
    wh, ww = cascade.window_size
    integral = np.zeros((h + 1, w + 1))
    integral[1:, 1:] = f.cumsum(0).cumsum(1)
    sqintegral = np.zeros((h + 1, w + 1))
    sqintegral[1:, 1:] = (f * f).cumsum(0).cumsum(1)
    ny, nx = (h - wh) // step + 1, (w - ww) // step + 1
    ys, xs = np.meshgrid(np.arange(ny) * step, np.arange(nx) * step, indexing="ij")

    def rect_sum(ii, x, y, rw, rh):
        return (ii[ys + y + rh, xs + x + rw] - ii[ys + y + rh, xs + x]
                - ii[ys + y, xs + x + rw] + ii[ys + y, xs + x])

    s1 = rect_sum(integral, 1, 1, ww - 2, wh - 2)
    s2 = rect_sum(sqintegral, 1, 1, ww - 2, wh - 2)
    nf2 = (wh - 2) * (ww - 2) * s2 - s1 * s1
    nf = np.where(nf2 > 0, np.sqrt(np.maximum(nf2, 0)), 1.0)
    passed = np.ones((ny, nx), dtype=bool)
    for si in range(cascade.n_stages):
        stage_sum = np.zeros((ny, nx))
        for s in range(cascade.stage_offsets[si], cascade.stage_offsets[si + 1]):
            val = np.zeros((ny, nx))
            for (x, y, rw, rh, wt) in cascade.rects[cascade.stump_feature[s]]:
                if wt != 0.0:
                    val += wt * rect_sum(integral, int(x), int(y), int(rw), int(rh))
            stage_sum += np.where(val < cascade.stump_threshold[s] * nf,
                                  cascade.leaf0[s], cascade.leaf1[s])
        passed &= stage_sum >= cascade.stage_thresholds[si]
    iy, ix = np.nonzero(passed)
    return {(int(x) * step, int(y) * step) for y, x in zip(iy, ix)}


def phase_haar(dev, card: str) -> None:
    path = haar.find_cascade()
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    cascade = haar.load_cascade(path)
    print(f"[haar] cascade {path} sha256 {digest}: {cascade.n_stages} stages, "
          f"{cascade.n_stumps} stumps")
    route = "native" if native.group_rectangles_native([(0, 0, 24, 24)] * 2, 1, 0.2) else "numpy"
    det = haar.HaarDetector(cascade, device=dev)
    on_cpu = haar.HaarDetector(cascade, device="cpu")
    fused_match.launches = gallery_match.launches = 0
    for size in ("544p", "1080p"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = bench.haar_detect(HAAR_BATCH, bench.SIZES[size], iters=3, seed=HAAR_SEED,
                                   device=dev, detector=det)
        frames, plants, handle = result["frames"], result["plants"], result["handle"]
        boxes = result["detections"]
        others = 0
        for i, (found, plant) in enumerate(zip(boxes, plants)):
            planted = bench.haar_planted_boxes(found, plant)
            check(len(planted) >= 1, f"{size} frame {i}: boxes {found}, planted (y, x, patch, "
                                     f"side) {plant.tolist()}")
            others += len(found) - len(planted)
        singles = [det.detect_multi_scale(frames[i]) for i in range(HAAR_BATCH)]
        check(singles == boxes, f"{size}: the batch equals the frames taken one by one")
        cpu_boxes = on_cpu.detect_multi_scale_batch(frames[:2].cpu())
        check(cpu_boxes == boxes[:2], f"{size}: card {boxes[:2]} against the CPU's {cpu_boxes}")

        # One level of frame 0 against the float64 numpy cascade: the level
        # that accepts most windows, resized as the detector resizes it.
        rows = handle["rows"].numpy()
        rows0 = rows[rows[:, 0] == 0]
        level = int(np.bincount(rows0[:, 1]).argmax())
        factor, sh, sw, step = handle["levels"][level]
        with port_device.exact_float32():
            scaled = resize_bilinear(frames[0], (sw, sh)).cpu().numpy()
        want = numpy_cascade_accepts(scaled, cascade, step)
        got = {(int(x), int(y)) for _, lv, y, x in rows0 if lv == level}
        check(got == want and len(got) > 0,
              f"{size} level {level}: card accepts {sorted(got)}, numpy cascade {sorted(want)}")

        traced = bench.traced_kernels(lambda: det.detect_device(frames), 2)
        check(bool(traced), f"{size}: torch.profiler saw the detector's kernels")
        device_ms = sum(us for _, us, _ in traced) / 1e3
        print(f"[haar] {size} batch {HAAR_BATCH}: every frame gives the planted face's box "
              f"(sides {[int(p[3]) for p in plants]}, boxes {[b[0][2] for b in boxes]}), "
              f"{others} other boxes; batch equals frame by frame; frames 0-1 equal the CPU's; "
              f"level {level} (factor {factor:.3f}, {sh} x {sw}, step {step}) of frame 0: "
              f"{len(got)} accepted windows equal the float64 numpy cascade's; "
              f"{len(handle['levels'])} levels, {handle['windows']} windows per frame, candidates "
              f"after (stage, left) {handle['survivors']}, raw rectangles {result['raw']}; "
              f"blocking {result['fps']} frames/s ({result['ms_per_batch']} ms per batch, best of "
              f"3), pipelined depth 6 {result['pipelined_fps']} frames/s "
              f"({result['pipelined_ms_per_batch']} ms per batch); device {device_ms} ms in "
              f"{sum(c for _, _, c in traced):.0f} kernels per batch (torch.profiler), busy share "
              f"{device_ms / result['ms_per_batch']}, by family "
              f"{json.dumps(bench.kernel_families(traced))}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; resize matrix cache "
              f"{port_resize.interp_cache_bytes() / 1e6:.1f} MB; group_rectangles route: {route}; "
              f"phase {time.perf_counter() - t0:.2f} s; card {card}")
        del result, frames, handle
        torch.cuda.empty_cache()
    check(fused_match.launches == 0 and gallery_match.launches == 0,
          "the Haar detector launches no hand-written kernel")


def phase_haar_pipeline(dev, card: str) -> None:
    size = bench.SIZES["544p"]
    h, w = size
    persons = {"person1": 1, "person2": 2}
    det = haar.HaarDetector(device=dev)
    meta = VideoMeta(w, h, 30.0, PIPELINE_TRAIN_FRAMES)
    fused_match.launches = gallery_match.launches = 0
    with tempfile.TemporaryDirectory() as lock_dir:
        train_seconds = []
        for name, person in persons.items():
            frames, plants = bench.haar_bgr_frames(PIPELINE_TRAIN_FRAMES, size, 100 + person,
                                                   persons=(person,))
            t0 = time.perf_counter()
            found, crops = detect_frames(iter(frames), meta, detector=det, video_path="synthetic",
                                         progress_every=0)
            train_seconds.append(time.perf_counter() - t0)
            check(found.total_frames == PIPELINE_TRAIN_FRAMES, f"{name}: frames seen")
            for i, plant in enumerate(plants):
                hits = [(r.x, r.y, r.width, r.height) for r in found.faces if r.frame_number == i]
                check(len(hits) == 1 and len(bench.haar_planted_boxes(hits, plant)) == 1,
                      f"{name} frame {i}: boxes {hits}, planted {plant.tolist()}")
            person_dir = os.path.join(lock_dir, name)
            os.makedirs(person_dir)
            json_path = os.path.join(person_dir, f"{name}_faces_detection.json")
            write_detection_json(found, json_path)
            back = read_detection_json(json_path)
            check([vars(r) for r in back.faces] == [vars(r) for r in found.faces]
                  and (back.total_frames, back.fps, back.total_faces_detected)
                  == (found.total_frames, found.fps, found.total_faces_detected),
                  f"{name}: the DetectionFile survives its JSON")
            rows = torch.cat([
                preprocess_crops(torch.from_numpy(crop[None]).to(dev), (64, 64)) for crop in crops])
            model, aux = train_v2(rows, torch.zeros(len(rows), dtype=torch.int32, device=dev),
                                  n_components=PIPELINE_K, face_shape=(64, 64))
            save_model_v2(to_artifact(model, aux, person_id_map={name: 0}, person_name=name),
                          os.path.join(person_dir, "face_model.pkl"))
        stack = ModelStack.from_lock_dir(lock_dir, device=dev)
    check(stack.model_names == list(persons), f"models read back: {stack.model_names}")

    frames, plants = bench.haar_bgr_frames(PIPELINE_SCAN_FRAMES, size, 7,
                                           persons=tuple(persons.values()))
    t0 = time.perf_counter()
    records = scan_frames_haar_multimodel(iter(frames), stack, detector=det)
    scan_seconds = time.perf_counter() - t0
    check([r["frame_number"] for r in records] == list(range(PIPELINE_SCAN_FRAMES)),
          f"one record per frame: {[r['frame_number'] for r in records]}")
    names = list(persons)
    for r, plant in zip(records, plants):
        i = r["frame_number"]
        box = (r["x"], r["y"], r["width"], r["height"])
        check(len(bench.haar_planted_boxes([box], plant)) == 1,
              f"frame {i}: box {box}, planted {plant.tolist()}")
        check(r["person_name"] == names[i % len(names)] and r["person_id"] == 0,
              f"frame {i}: named {r['person_name']} ({r['confidence']})")
    check(fused_match.launches == 0 and gallery_match.launches == 0,
          "the Haar flows launch no hand-written kernel")
    train_fps = [PIPELINE_TRAIN_FRAMES / seconds for seconds in train_seconds]
    print(f"[haar-pipeline] {len(persons)} persons x {PIPELINE_TRAIN_FRAMES} uint8 BGR 544p frames "
          f"through detect_frames ({DETECT_BATCH} frames per detector call): one face per frame at the "
          f"planted place, {train_fps} frames/s per person with the host-to-device copies "
          f"inside (the first person's run builds the detector's stage tensors and resize "
          f"matrices); the DetectionFiles survive their JSON; train_v2 models (k {PIPELINE_K}, 64 x "
          f"64) written and read back through a temporary lock directory; "
          f"{PIPELINE_SCAN_FRAMES} fresh frames through scan_frames_haar_multimodel: one record "
          f"per frame with the planted box and person, min confidence "
          f"{min(r['confidence'] for r in records):.6f}, "
          f"{PIPELINE_SCAN_FRAMES / scan_seconds} frames/s (host clock); card {card}")


def _band_boxes(parts, k: int, band_of) -> set:
    """The boxes, in frame coordinates, of every top-(k + 1) member within
    its part's band of the k-th score."""
    boxes = set()
    for (scale, (th, tw), (sh, sw), vals, idx, _), band in zip(parts, band_of):
        ow, oh = sw - tw + 1, sh - th + 1
        for j in idx[np.abs(vals - vals[k - 1]) <= band]:
            p = int(j) % (oh * ow)
            boxes.add((int((p % ow) / scale), int((p // ow) / scale), int(tw / scale),
                       int(th / scale)))
    return boxes


def phase_ccoeff(dev, card: str) -> None:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = bench.ccoeff_detect(CCOEFF_BATCH, bench.SIZES["1080p"], CCOEFF_SEED, device=dev)
    det, frames, plants = result["detector"], result["frames"], result["plants"]
    check(det.max_candidates == CCOEFF_K, f"k {det.max_candidates}")
    for i, (boxes, plant) in enumerate(zip(result["detections"], plants)):
        check(len(bench.ccoeff_planted(boxes, plant)) >= 1,
              f"frame {i}: survivors {boxes[:8]}, planted (y, x) {plant.tolist()}")
    on_cpu = CcoeffTemplateDetector(result["templates"], device="cpu")
    for (s_card, lv_card), (s_cpu, lv_cpu) in zip(det.levels(frames[0]), on_cpu.levels(frames[0])):
        check(torch.equal(lv_card.cpu(), lv_cpu), f"scale {s_card}: levels equal the CPU's")
    parts_card, parts_cpu = det.topk(frames[0]), on_cpu.topk(frames[0])
    gaps, band_of, differ = [], [], 0
    for pc, pp in zip(parts_card, parts_cpu):
        vals_c, idx_c, vals_p, idx_p, peak = pc[3], pc[4], pp[3], pp[4], pp[5]
        band = CCOEFF_BAND * peak
        band_of.append(band)
        gaps.append(float(vals_p[CCOEFF_K - 1] - vals_p[CCOEFF_K]) / peak)
        odd = set(idx_c[:CCOEFF_K].tolist()) ^ set(idx_p[:CCOEFF_K].tolist())
        differ += len(odd)
        for j in odd:
            v = vals_c[idx_c == j] if j in idx_c else vals_p[idx_p == j]
            check(abs(float(v[0]) - float(vals_p[CCOEFF_K - 1])) <= band,
                  f"scale {pc[0]}: top-k member {j} differs and is no near-tie")
        common = {int(j): float(v) for j, v in zip(idx_p[:CCOEFF_K], vals_p[:CCOEFF_K])}
        d = [abs(float(v) - common[int(j)]) for j, v in zip(idx_c[:CCOEFF_K], vals_c[:CCOEFF_K])
             if int(j) in common]
        check(max(d) <= band, f"scale {pc[0]}: scores within {CCOEFF_BAND} of the largest")
    surv = {"card": set(det.select(parts_card)), "cpu": set(on_cpu.select(parts_cpu))}
    odd_boxes = surv["card"] ^ surv["cpu"]
    near = _band_boxes(parts_card, CCOEFF_K, band_of) | _band_boxes(parts_cpu, CCOEFF_K, band_of)
    check(odd_boxes <= near, f"survivors differ beyond near-ties: {sorted(odd_boxes - near)}")
    check(surv["card"] == set(result["detections"][0]), "detect equals select(topk)")

    rows = bench.traced_kernels(lambda: det.detect(frames[0]), 2)
    check(bool(rows), "torch.profiler saw the CCOEFF detector's kernels")
    with tempfile.TemporaryDirectory() as logdir:
        t1 = time.perf_counter()
        with device_trace(logdir):
            for f in frames:
                det.detect(f)
        trace_s = time.perf_counter() - t1
        trace = os.path.join(logdir, "trace.json")
        check(os.path.exists(trace), "device_trace wrote its trace file")
        trace_mb = os.path.getsize(trace) / 1e6
    print(f"[ccoeff] 1080p x {CCOEFF_BATCH} frames, {det.n_templates} templates of 100 x 100 in "
          f"{len(det.groups)} group, scales {list(det.scales)}, k {CCOEFF_K}: every frame's "
          f"survivors hold the planted box ({[len(b) for b in result['detections']]} survivors); "
          f"frame 0 levels equal the CPU's bit for bit; gap at rank k per (scale, group) "
          f"{['%.2e' % g for g in gaps]} of the largest |score|, {differ} top-k members differ "
          f"from the CPU's (all near-ties), survivors {len(surv['card'])} card / "
          f"{len(surv['cpu'])} CPU, differing {sorted(odd_boxes)}; {result['fps']} frames/s "
          f"({result['ms_per_frame']} ms per frame, best of 3, host NMS inside); device ms per "
          f"frame by family {json.dumps(bench.kernel_families(rows))} in "
          f"{sum(c for _, _, c in rows):.0f} kernels; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; one pass inside device_trace "
          f"{trace_s:.2f} s ({trace_mb:.1f} MB trace); phase {time.perf_counter() - t0:.2f} s; "
          f"card {card}")
    del result, det
    torch.cuda.empty_cache()


def phase_enhanced(dev, card: str) -> None:
    h, w = bench.SIZES["1080p"]
    t0 = time.perf_counter()
    train_frames, frames, plants, person_ids, fresh_frames, profile_crops = (
        bench.enhanced_assets(ENHANCED_SCAN, (h, w), ENHANCED_SEED))
    det = haar.HaarDetector(device=dev)
    fused_match.launches = gallery_match.launches = 0
    crops, labels = [], []
    for label, (person_frames, person_plants) in enumerate(train_frames):
        found, found_crops = detect_frames(
            iter(person_frames), VideoMeta(w, h, 30.0, len(person_frames)), detector=det,
            progress_every=0)
        # The planted face's crop of every frame.
        keep = [c for r, c in zip(found.faces, found_crops) if bench.haar_planted_boxes(
            [(r.x, r.y, r.width, r.height)], person_plants[r.frame_number])]
        check(len(keep) == bench.ENHANCED_PER_PERSON and len(found_crops) == len(keep),
              f"person {label}: {len(keep)} planted crops of {len(found_crops)}")
        crops += [bgr_to_gray_exact(torch.from_numpy(c).to(dev)) for c in keep]
        labels += [label] * len(keep)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = enhanced.train_enhanced(crops, labels, person_ids, n_components=ENHANCED_K, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    rows = {b: tuple(br.gallery.shape) for b, br in model.branches.items()}
    check(all(r[0] == 7 * len(crops) == 1078 for r in rows.values()), f"gallery rows {rows}")

    timer = StageTimer()
    t2 = time.perf_counter()
    records = scan_frames_enhanced(iter(frames), model, detector=det, timer=timer)
    scan_s = time.perf_counter() - t2
    names = {v: k for k, v in person_ids.items()}
    check([r["frame_number"] for r in records] == list(range(ENHANCED_SCAN)),
          f"one record per frame: {[r['frame_number'] for r in records]}")
    on_cpu = model.to("cpu")
    crops_cpu, profiles = [], []
    for r, plant in zip(records, plants):
        i, box = r["frame_number"], (r["x"], r["y"], r["width"], r["height"])
        check(len(bench.haar_planted_boxes([box], plant)) == 1,
              f"frame {i}: box {box}, planted {plant.tolist()}")
        want = names[i % len(names)]
        check(r["person_name"] == want, f"frame {i}: named {r['person_name']}, want {want}")
        profile = r["angle"] != "frontal"
        limit = enhanced.PROFILE_THRESHOLD if profile else enhanced.FRONTAL_THRESHOLD
        check(r["confidence"] >= limit, f"frame {i}: confidence {r['confidence']} < {limit}")
        x, y, bw, bh = box
        crop = torch.from_numpy(np.ascontiguousarray(frames[i, y:y + bh, x:x + bw, 0]))
        check(enhanced.detect_face_angle(crop, "cpu") == r["angle"], f"frame {i}: angle")
        crops_cpu.append(crop)
        profiles.append(profile)
    again = enhanced.recognize_enhanced_batch(on_cpu, crops_cpu, profiles)
    err = max(abs(c - r["confidence"]) for (_, _, c), r in zip(again, records))
    check([p for p, _, _ in again] == [r["person_id"] for r in records] and err <= CONF_ATOL,
          f"the model on the CPU: ids {[p for p, _, _ in again]}, max|dconf| {err}")

    # What the model has not seen: fresh frames through the scan, and whole
    # face patches the profile cascade takes for profiles.  The card against
    # the CPU copy, with no threshold held: an id may differ only where the
    # confidence is within CONF_ATOL of its threshold.
    fresh = scan_frames_enhanced(iter(fresh_frames), model, detector=det)
    check(sorted({r["frame_number"] for r in fresh}) == list(range(len(fresh_frames))),
          f"a record for every fresh frame: {[r['frame_number'] for r in fresh]}")
    probes = [np.ascontiguousarray(fresh_frames[r["frame_number"], r["y"]:r["y"] + r["height"],
                                                r["x"]:r["x"] + r["width"], 0]) for r in fresh]
    probes += profile_crops
    angles = [r["angle"] for r in fresh] + [
        enhanced.detect_face_angle(torch.from_numpy(c).to(dev), dev) for c in profile_crops]
    angles_cpu = [enhanced.detect_face_angle(c, "cpu") for c in probes]
    check(angles == angles_cpu, f"unseen crops' angles {angles}, on the CPU {angles_cpu}")
    flags = [a != "frontal" for a in angles]
    check(any(flags), f"a crop the profile cascade accepts: {angles}")
    got = [(r["person_id"], r["person_name"], r["confidence"]) for r in fresh]
    got += enhanced.recognize_enhanced_batch(model, profile_crops, flags[len(fresh):])
    want = enhanced.recognize_enhanced_batch(on_cpu, probes, flags)
    probe_err = max(abs(a[2] - b[2]) for a, b in zip(got, want))
    check(probe_err <= CONF_ATOL, f"unseen crops: max|dconf| {probe_err} against the CPU")
    for j, ((pid, _, _), (want_id, _, conf), profile) in enumerate(zip(got, want, flags)):
        limit = enhanced.PROFILE_THRESHOLD if profile else enhanced.FRONTAL_THRESHOLD
        check(pid == want_id or abs(conf - limit) <= CONF_ATOL,
              f"unseen crop {j}: id {pid} on the card, {want_id} on the CPU (confidence {conf})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "enhanced_model.pkl")
        enhanced.save_enhanced(model, path)
        back = enhanced.load_enhanced(path, dev)
    for b, br in model.branches.items():
        other = back.branches[b]
        check(all(torch.equal(a, o) for a, o in (
            (br.components, other.components), (br.gallery, other.gallery),
            (br.projection_mean, other.projection_mean), (br.scaler.mean, other.scaler.mean),
            (br.scaler.scale, other.scaler.scale))), f"{b}: the pickle gives equal arrays")
    check(np.array_equal(back.labels, model.labels), "the pickle gives equal labels")
    check(fused_match.launches == 0 and gallery_match.launches == 0,
          "the enhanced flow launches no hand-written kernel")
    print(f"[enhanced] 2 persons x {bench.ENHANCED_PER_PERSON} 1080p frames -> {len(crops)} Haar crops "
          f"(sides 120-220) -> train_enhanced on the card in {train_s:.3f} s (gallery rows "
          f"{rows['hog'][0]}, k per branch "
          f"{ {b: br.components.shape[0] for b, br in model.branches.items()} }); "
          f"{ENHANCED_SCAN} BGR 1080p frames through scan_frames_enhanced: one record per frame "
          f"with the planted box and person, angles {sorted(set(r['angle'] for r in records))} "
          f"equal to the CPU's, min confidence {min(r['confidence'] for r in records):.6f}, the "
          f"model on the CPU gives the same ids, max|dconf| {err:.3g}; {len(fresh)} records of "
          f"{len(fresh_frames)} fresh frames and {len(profile_crops)} whole face patches: angles "
          f"{angles} equal to the CPU's, ids {[p for p, _, _ in got]}, "
          f"confidences {[round(c, 6) for _, _, c in got]} (profile threshold "
          f"{enhanced.PROFILE_THRESHOLD}, frontal {enhanced.FRONTAL_THRESHOLD}), max|dconf| "
          f"{probe_err:.3g} against the CPU copy; the pickle round trip "
          f"gives equal arrays; {ENHANCED_SCAN / scan_s} frames/s with the copies inside (host "
          f"clock); seconds per stage "
          f"{json.dumps({k: round(v, 4) for k, v in timer.totals.items()})}; phase "
          f"{time.perf_counter() - t0:.2f} s; card {card}")


def phase_flow(dev, card: str) -> int:
    h, w = bench.SIZES["1080p"]
    t0 = time.perf_counter()
    frames, plants, eval_crops, eval_ids = bench.pipeline_assets(FLOW_FRAMES, (h, w), FLOW_SEED)
    person = f"person{bench.PIPELINE_PERSON}"
    det = haar.HaarDetector(device=dev)
    fused_match.launches = gallery_match.launches = 0
    with tempfile.TemporaryDirectory() as lock_dir:
        t1 = time.perf_counter()
        out = run_pipeline_frames(frames, VideoMeta(w, h, 30.0, FLOW_FRAMES), person,
                                  lock_dir=lock_dir, detector=det, device=dev)
        flow_s = time.perf_counter() - t1
        written = sorted(os.listdir(os.path.join(lock_dir, person)))
    check(out["faces_detected"] == FLOW_FRAMES, f"{out['faces_detected']} faces detected")
    check(out["n_components"] == min(50, FLOW_FRAMES - 1), f"n_components {out['n_components']}")
    check(written == sorted([f"{person}_faces_detection.json", "face_model.pkl",
                             f"{person}_model_info.json"]), f"files written {written}")
    records = out["records"]
    check([r["frame_number"] for r in records] == list(range(FLOW_FRAMES)),
          f"a record per frame: {[r['frame_number'] for r in records]}")
    for r, plant in zip(records, plants):
        box = (r["x"], r["y"], r["width"], r["height"])
        check(len(bench.haar_planted_boxes([box], plant)) == 1 and r["person_name"] == person,
              f"frame {r['frame_number']}: box {box} named {r['person_name']}, planted "
              f"{plant.tolist()}")
    model = from_artifact(out["artifact"], torch.float32, dev)
    own = eval_ids.count(0)
    stats = evaluate_model(model, eval_crops[:own], eval_ids[:own])
    check(stats["top1_accuracy"] == 1.0, f"evaluate_model {stats}")
    # Both persons at the PCA gate, crop by crop, against the model copied
    # to the CPU: a one-person model's id is 0 or -1, so top-1 and the
    # reject rate of one crop name its id.
    gate = RecognizeConfig().pca_gate
    gated = evaluate_model(model, eval_crops, eval_ids, threshold=gate)
    on_cpu = from_artifact(out["artifact"], torch.float32, "cpu")
    eval_err = 0.0
    for j, (crop, want) in enumerate(zip(eval_crops, eval_ids)):
        a = evaluate_model(model, [crop], [want], threshold=gate)
        b = evaluate_model(on_cpu, [crop], [want], threshold=gate)
        eval_err = max(eval_err, abs(a["mean_confidence"] - b["mean_confidence"]))
        check(a["reject_rate"] == b["reject_rate"]
              or abs(b["mean_confidence"] - gate) <= CONF_ATOL,
              f"eval crop {j}: card {a}, CPU {b}")
    check(eval_err <= CONF_ATOL, f"evaluate_model: max|dconf| {eval_err} against the CPU")
    check(fused_match.launches == 0 and gallery_match.launches == 0,
          "the flow launches no hand-written kernel")
    print(f"[pipeline] run_pipeline_frames on {FLOW_FRAMES} BGR 1080p frames of {person}: "
          f"{out['faces_detected']} faces, n_components {out['n_components']}, a record per frame "
          f"with the planted box and name (min confidence "
          f"{min(r['confidence'] for r in records):.6f}, min template confidence "
          f"{min(r['template_match_confidence'] for r in records):.6f}), files {written}; "
          f"{FLOW_FRAMES / flow_s} frames/s for detect + train + scan (host clock); "
          f"evaluate_model on {own} fresh crops {json.dumps(stats)}; with {len(eval_crops) - own} "
          f"of person{bench.PIPELINE_STRANGER} at the gate {gate} {json.dumps(gated)}, crop by "
          f"crop the CPU copy's ids, max|dconf| {eval_err:.3g}; card {card}")

    # fdrp-torch bench --streams 4 (256 frames per dispatch) three times:
    # each reading's fps, and its windows on the host clock and by CUDA
    # events, so a slow reading shows which clock saw it.
    fused_match.launches = gallery_match.launches = 0
    readings = []
    t2 = time.perf_counter()
    for _ in range(CLI_BENCH_READINGS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--streams", "4", "--size", "1080p"])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        detail = line["detail"]
        check(rc == 0 and detail["self_check"] == "ok" and line["value"] > 0,
              f"cli bench self-check: {detail['self_check']}")
        check(detail["device"] == card, f"cli bench ran on {detail['device']}")
        check(len(detail["window_step_ms"]) == len(detail["event_step_ms"]) == 3,
              "cli bench reports every window on both clocks")
        readings.append(line)
        print(f"[pipeline] cli.main(['bench', '--streams', '4', '--size', '1080p']) reading "
              f"{len(readings)}: {line['value']} {line['unit']}, self-check {detail['self_check']}, "
              f"{detail['frames_per_dispatch']} frames per dispatch, step {detail['step_ms']} ms; "
              f"windows (ms per dispatch) host clock {detail['window_step_ms']}, CUDA events "
              f"{detail['event_step_ms']}; device {detail['device_ms']} ms, busy share "
              f"{detail['busy_share']}")
    bench_s = time.perf_counter() - t2
    launches = fused_match.launches
    check(launches >= CLI_BENCH_READINGS
          and launches == sum(r["detail"]["fused_match_launches"] for r in readings),
          f"cli bench launched fused_match {launches} times")

    def spread(values) -> str:
        return f"{min(values):.4f}-{max(values):.4f} ({max(values) / min(values):.3f}x)"

    host = [v for r in readings for v in r["detail"]["window_step_ms"]]
    event = [v for r in readings for v in r["detail"]["event_step_ms"]]
    print(f"[pipeline] cli bench, {CLI_BENCH_READINGS} readings with no --device: frames/s/card "
          f"{[r['value'] for r in readings]}; ms per dispatch over all {len(host)} windows: host "
          f"clock {spread(host)}, CUDA events {spread(event)}; fused_match launches {launches}, "
          f"{bench_s:.2f} s; phase {time.perf_counter() - t0:.2f} s; {card_and_limit()}")
    return launches


def _distributed_inputs(dev, with_gallery: bool) -> tuple:
    """Phase 6's inputs, made again from its seeds: ``(images, probes,
    feats, galleries, labels, want)``; the large gallery's part (features,
    the gallery in float32 and bfloat16, labels and the planted labels) is
    None without ``with_gallery``."""
    images = bench.structured_faces(TRAIN_N, TRAIN_SIDE, TRAIN_K, TRAIN_SEED, dev)
    probes = images[:256].reshape(-1, TRAIN_SIDE, TRAIN_SIDE)
    if not with_gallery:
        return images, probes, None, None, None, None
    feats, gallery, labels, planted = bench.large_gallery_assets(
        GALLERY_B, GALLERY_K, GALLERY_N, GALLERY_SEED, dev)
    galleries = {torch.float32: gallery, torch.bfloat16: gallery.to(torch.bfloat16)}
    return images, probes, feats, galleries, labels, labels[torch.from_numpy(planted).to(dev)]


def _distributed_calls(mode: str, mesh, inputs: tuple, model, crops) -> dict:
    """Phase 16's main path on ``mesh`` as named calls: the train step; on
    the NCCL path the identification call in float32 and bfloat16; and
    ``dp_recognize`` of the 1024 crops."""
    images, probes, feats, galleries, labels, _ = inputs
    calls = {"train": lambda: multichip_train_step(mesh, images, probes, TRAIN_K,
                                                   (TRAIN_SIDE, TRAIN_SIDE))}
    if mode == "nccl":
        for dt, g in galleries.items():
            calls[f"match {str(dt)[6:]}"] = (
                lambda g=g: sharded_gallery_match(mesh, feats, g, labels))
    calls["dp"] = lambda: dp_recognize(mesh, model, crops)
    return calls


def _track_case(msr, frames, boxes0) -> dict:
    """One pass of ``process_batch`` over every frame batch and one
    ``process_window`` of them all, from the first plants: the results and
    final origins on the host."""
    hw = tuple(frames.shape[2:])
    state = msr.init_state(STREAMS, hw, boxes0)
    steps = []
    for f in range(frames.shape[0]):
        out, state = msr.process_batch(frames[f], state)
        steps.append(out)
    window, window_state = msr.process_window(frames, msr.init_state(STREAMS, hw, boxes0))
    host = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    return {"batch": [host(o) for o in steps], "batch_origin": state.origin.cpu(),
            "window": host(window), "window_origin": window_state.origin.cpu()}


def _same_track(a: dict, b: dict) -> bool:
    return (all(torch.equal(x[k], y[k]) for x, y in zip(a["batch"], b["batch"]) for k in x)
            and len(a["batch"]) == len(b["batch"])
            and all(torch.equal(a["window"][k], b["window"][k]) for k in a["window"])
            and torch.equal(a["batch_origin"], b["batch_origin"])
            and torch.equal(a["window_origin"], b["window_origin"]))


def distributed_worker(mode: str, tmp: str) -> int:
    """One rank of phase 16, started by the phase as ``chip_smoke.py
    --distributed-worker MODE DIR`` with the ``FDRP_*`` variables set: it
    joins the group (NCCL on its card, or gloo when ``MODE`` is ``gloo``),
    runs the main path on ``global_mesh`` with the model and crops the
    parent wrote into ``DIR``, writes the results there and prints one
    ``RESULT:`` line; the gloo ranks then run ``bench.dryrun_multichip(8,
    n_hosts=2)``."""
    t0 = time.perf_counter()
    joined = initialize_multihost() if mode == "nccl" else initialize_multihost(backend="gloo")
    join_s = time.perf_counter() - t0
    check(joined and dist.get_backend() == mode, f"joined a {mode} group")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        check(world == DIST_WORLD[mode], f"{mode}: world size {world}")
        torch.set_float32_matmul_precision("highest")
        port_device.disable_tf32()
        dev = torch.device("cuda", torch.cuda.current_device())
        saved = torch.load(os.path.join(tmp, "inputs.pt"))
        model = from_params({k: None if v is None else v.numpy() for k, v in saved["params"].items()},
                            (TRAIN_SIDE, TRAIN_SIDE), "v1", dev)
        crops = saved["crops"].to(dev)
        inputs = _distributed_inputs(dev, with_gallery=mode == "nccl")
        mesh = global_mesh(*DIST_MESHES[mode], devices=[dev] * (8 // world))
        rows = [sorted(set(row)) for row in mesh.ranks.tolist()]
        check(mesh.devices.shape == DIST_MESHES[mode] and rows == [[r] for r in range(world)]
              and mesh.spans_processes == (world > 1), f"{mode}: mesh {mesh}, rows owned {rows}")
        calls = _distributed_calls(mode, mesh, inputs, model, crops)

        fused_match.launches = gallery_match.launches = 0
        out = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        launches = gallery_match.launches
        want = (3 if mode == "nccl" else 1) * mesh.shape["model"]
        check(launches == want, f"{mode} rank {rank}: gallery_match launched {launches}, want {want}")
        check(fused_match.launches == 0, "the distributed path does not use the fused kernel")
        if mode == "nccl":
            for dt in inputs[3]:
                check(torch.equal(out[f"match {str(dt)[6:]}"][0], inputs[5]),
                      f"nccl {dt}: every probe named by its planted label")
        torch.save({name: tuple(t.cpu() for t in res) for name, res in out.items()},
                   os.path.join(tmp, f"{mode}_rank{rank}.pt"))

        ms = {name: _best_time(fn) * 1e3 for name, fn in calls.items()}

        # The tracker slice on the same mesh, the model the parent trained.
        tracker_model = from_params(
            {k: None if v is None else v.numpy() for k, v in saved["tracker"].items()},
            (bench.TPL, bench.TPL), "v1", dev)
        msr, frames, plants, boxes0, _ = bench.tracker_recognizer(
            STREAMS, bench.SIZES["1080p"], DIST_TRACKER_BATCHES[mode], SEED, dev, mesh,
            tracker_model)
        fused_match.launches = 0
        tracked = _track_case(msr, frames, boxes0)
        torch.cuda.synchronize()
        tracker_launches = fused_match.launches
        steps = frames.shape[0]
        owned = mesh.axis_owners("data").count(rank)
        check(tracker_launches == 2 * steps * owned,
              f"{mode} rank {rank}: fused_match launched {tracker_launches} times for the tracker, "
              f"want {2 * steps * owned}")
        check(bench.planted_exact(tracked["batch"], plants)
              and bench.planted_exact(tracked["window"], plants),
              f"{mode} rank {rank}: the tracker planted-exact")
        torch.save(tracked, os.path.join(tmp, f"{mode}_rank{rank}_tracker.pt"))
        hw = tuple(frames.shape[2:])

        def batch_pass():
            state = msr.init_state(STREAMS, hw, boxes0)
            for f in range(steps):
                state = msr.process_batch(frames[f], state)[1]
            return state

        step_ms = {"process_batch": _best_time(batch_pass) * 1e3 / steps,
                   "process_window": _best_time(lambda: msr.process_window(
                       frames, msr.init_state(STREAMS, hw, boxes0))) * 1e3 / steps}
        # The step's gather of every window: this rank's chunks of the first
        # step's windows, gathered chunk by chunk from their owners.
        owners = mesh.axis_owners("data")
        windows = torch.chunk(slice_windows(frames[0], msr.init_state(STREAMS, hw, boxes0).origin,
                                            bench.WIN), len(owners))
        local = {i: windows[i] for i, owner in enumerate(owners) if owner == rank}
        dist.barrier()
        t1 = time.perf_counter()
        for _ in range(DIST_GATHER_CALLS):
            gathered = _gather_chunks(local, owners)
        torch.cuda.synchronize()
        window_gather_ms = (time.perf_counter() - t1) / DIST_GATHER_CALLS * 1e3
        check(tuple(gathered.shape) == (STREAMS, bench.WIN, bench.WIN),
              "the window gather holds every stream's window")
        print(f"[distributed] {mode} rank {rank}/{world}: tracker, {STREAMS} streams of 1080p, "
              f"{steps} frame batches, planted-exact, fused_match launches {tracker_launches}; ms "
              f"per frame step (host clock, best of 3 passes): "
              + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items())
              + f"; gather of the step's {gathered.numel() * 4 / 1e6:.1f} MB of windows "
              f"{window_gather_ms:.3f} ms")
        del frames, msr

        conf = out["dp"][1]
        dist.barrier()
        t1 = time.perf_counter()
        for _ in range(DIST_GATHER_CALLS):
            parts = all_gather_in_rank_order(conf)
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t1) / DIST_GATHER_CALLS * 1e3
        check(torch.equal(parts[rank], conf), "the gather hands back this rank's part")
        where = ("NCCL at world size 1" if mode == "nccl"
                 else "gloo through host copies, both ranks sharing one card")
        print(f"[distributed] {mode} rank {rank}/{world}: joined in {join_s:.2f} s; mesh "
              f"{DIST_MESHES[mode]} of {8 // world} entries of {dev} per rank, rows owned by ranks "
              f"{rows}; gallery_match launches {launches}; ms per call (host clock, best of 3): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; all_gather_in_rank_order of the {conf.numel()} float32 confidences "
              f"{gather_ms:.4f} ms ({where})")
        print("RESULT:" + json.dumps({"rank": rank, "launches": launches, "join_s": join_s,
                                      "ms": ms, "gather_ms": gather_ms,
                                      "tracker_launches": tracker_launches,
                                      "tracker_step_ms": step_ms,
                                      "window_gather_ms": window_gather_ms}), flush=True)
        if mode == "gloo":
            bench.dryrun_multichip(8, n_hosts=2)
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(mode: str, tmp: str) -> dict:
    """Start every rank of ``mode`` at once; rank -> (output, its RESULT
    object).  A rank that exits nonzero, outlives ``DIST_TIMEOUT`` or prints
    no result fails the phase, and every rank still running is killed."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    world = DIST_WORLD[mode]
    procs, logs = [], []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
        env.update(FDRP_COORDINATOR=f"127.0.0.1:{port}", FDRP_NUM_PROCESSES=str(world),
                   FDRP_PROCESS_ID=str(rank))
        logs.append(open(os.path.join(tmp, f"{mode}_rank{rank}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--distributed-worker", mode, tmp],
            cwd=here, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    outs = {}
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        check(p.returncode == 0, f"{mode} rank {rank} exited {p.returncode}:\n{text[-6000:]}")
        results = [ln[len("RESULT:"):] for ln in text.splitlines() if ln.startswith("RESULT:")]
        check(len(results) == 1, f"{mode} rank {rank} printed no result:\n{text[-6000:]}")
        for line in text.splitlines():
            if line.startswith(("[distributed]", "multi-host:", "dryrun_multichip")):
                print(line)
        outs[rank] = (text, json.loads(results[0]))
    return outs


def hold_train_step_shards(m, mesh, images, probes, step) -> None:
    """The gallery kernel at the shapes ``multichip_train_step`` gives it
    on ``mesh``: the step's gallery (the sharded projection, every label
    0) and its probes' features, made as the step makes them, one call per
    shard held against the plain version.  The shards' bests, combined,
    must be the step's confidences bit for bit."""
    comps, mean, proj, _ = snapshot_pca_sharded(mesh, images, TRAIN_K)
    labels = torch.zeros(proj.shape[0], dtype=torch.int32, device=proj.device)
    model = EigenfacesModel(components=comps, projection_mean=mean, mean_face=mean, gallery=proj,
                            labels=labels, face_shape=(TRAIN_SIDE, TRAIN_SIDE), schema="v1")
    feats = extract_features(model, probes)
    rows = -(-proj.shape[0] // mesh.shape["model"])
    bests = []
    for s in range(mesh.shape["model"]):
        shard = proj[s * rows:(s + 1) * rows]
        gnorm = torch.linalg.vector_norm(shard, dim=1, dtype=torch.float32)
        bests.append(hold_gallery_kernel("distributed", f"train step {m} shard {s}", feats,
                                         shard.T, gnorm, torch.float32, True)[1])
        if s == 0:
            # Shard 0 holds the probes' own rows (cosines about 1): both
            # paths against the cosines in float64 on the card.
            f64, g64 = feats.double(), shard.double()
            best64 = ((f64 @ g64.T) / (torch.linalg.vector_norm(f64, dim=1)[:, None]
                                       * torch.linalg.vector_norm(g64, dim=1)[None, :])).max(1)
            plain = _gallery_match_plain(feats, shard.T, gnorm, operand_dtype=torch.float32)[1]
            err_k = float((bests[0].double() - best64.values).abs().max())
            err_p = float((plain.double() - best64.values).abs().max())
            print(f"[distributed] train step {m} shard 0 against float64 cosines on the card: "
                  f"max|dbest| kernel {err_k:.3g}, plain {err_p:.3g}")
    check(torch.equal(torch.stack(bests).max(dim=0).values, step[1]),
          f"{m}: the shards' bests combine to the train step's confidences")


def phase_distributed(dev, card: str) -> tuple:
    """Phase 16; returns the gallery kernel's launches and the fused
    kernel's (the tracker), each summed over the ranks' main paths, and
    the fused kernel held and timed at the gloo ranks' shape."""
    t0 = time.perf_counter()
    inputs = _distributed_inputs(dev, with_gallery=True)
    images, probes = inputs[:2]
    model, crops = _dp_model_and_crops(images)
    refs = {}
    for mode, shape in DIST_MESHES.items():
        mesh = make_mesh(*shape, devices=[dev] * 8)
        refs[mode] = {name: fn() for name, fn in
                      _distributed_calls(mode, mesh, inputs, model, crops).items()}
    for dt in inputs[3]:
        check(torch.equal(refs["nccl"][f"match {str(dt)[6:]}"][0], inputs[5]),
              f"one-process (1, 8) {dt}: every probe named by its planted label")
    # The tracker slice's references: a model trained here (the ranks load
    # it), each mode's frames through a one-process mesh of its shape.
    tracker_model, tracker_refs = None, {}
    for mode, shape in DIST_MESHES.items():
        msr, frames, plants, boxes0, tracker_model = bench.tracker_recognizer(
            STREAMS, bench.SIZES["1080p"], DIST_TRACKER_BATCHES[mode], SEED, dev,
            make_mesh(*shape, devices=[dev] * 8), tracker_model)
        tracker_refs[mode] = _track_case(msr, frames, boxes0)
        check(bench.planted_exact(tracker_refs[mode]["batch"], plants)
              and bench.planted_exact(tracker_refs[mode]["window"], plants),
              f"one-process {shape} tracker planted-exact")
        del frames, msr
    torch.cuda.synchronize()
    print(f"[distributed] one-process references on (1, 8) and (2, 4) meshes of {dev}, the "
          f"tracker's planted-exact: {time.perf_counter() - t0:.2f} s")
    # Each gloo rank tracks half the streams: one launch at B = 32 per step.
    gloo_b = STREAMS // DIST_MESHES["gloo"][0]
    b32 = hold_fused_at(dev, gloo_b, bench.TPL * bench.TPL, "tracker_distributed")

    # The references themselves, on both meshes: the train step against the
    # dense PCA, the gallery kernel on each of the step's shards against its
    # plain version, and dp_recognize against recognize.
    dense = snapshot_pca(images, TRAIN_K)
    ids_s, conf_s = recognize(model, crops)
    for mode, shape in DIST_MESHES.items():
        m = f"({shape[0]},{shape[1]})"
        mesh = make_mesh(*shape, devices=[dev] * 8)
        check_train_step("distributed", m, mesh, refs[mode]["train"], images, dense)
        hold_train_step_shards(m, mesh, images, probes, refs[mode]["train"])
        ids, conf = refs[mode]["dp"]
        err = float((conf - conf_s).abs().max())
        check(torch.equal(ids, ids_s), f"{m}: dp_recognize ids equal recognize's")
        check(err <= CONF_ATOL, f"{m}: dp_recognize conf error {err}")
        print(f"[distributed] dp_recognize {m} vs recognize, {GALLERY_B} crops: ids equal, "
              f"max|dconf| {err:.3g}")
    launches = tracker_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        params = lambda m: {n: None if getattr(m, n) is None else getattr(m, n).cpu()  # noqa: E731
                            for n in PARAM_NAMES}
        torch.save({"params": params(model), "crops": crops.cpu(),
                    "tracker": params(tracker_model)}, os.path.join(tmp, "inputs.pt"))
        for mode, shape in DIST_MESHES.items():
            t1 = time.perf_counter()
            outs = _run_ranks(mode, tmp)
            for rank, (text, result) in outs.items():
                got = torch.load(os.path.join(tmp, f"{mode}_rank{rank}.pt"))
                check(got.keys() == refs[mode].keys(), f"{mode} rank {rank}: {sorted(got)}")
                for name, ref in refs[mode].items():
                    check(all(torch.equal(a, b.cpu()) for a, b in zip(got[name], ref)),
                          f"{mode} rank {rank} {name}: bit for bit the one-process {shape} mesh's")
                tracked = torch.load(os.path.join(tmp, f"{mode}_rank{rank}_tracker.pt"))
                check(_same_track(tracked, tracker_refs[mode]),
                      f"{mode} rank {rank} tracker: bit for bit the one-process {shape} mesh's")
                tracker_launches += result["tracker_launches"]
                if mode == "gloo":
                    check(f"multi-host: process {rank}/2, 8 global devices" in text
                          and "dryrun_multichip OK: mesh data=2 x model=4" in text,
                          f"gloo rank {rank}: the dryrun's two lines")
                launches += result["launches"]
            print(f"[distributed] {mode}, world size {len(outs)}: "
                  + ", ".join(f"{name} {tuple(ref[0].shape)}" for name, ref in refs[mode].items())
                  + f", and the tracker's {DIST_TRACKER_BATCHES[mode]} process_batch steps, "
                  f"process_window and final origins, equal bit for bit on every rank to the "
                  f"one-process {shape} mesh; gallery_match launches by rank "
                  f"{[outs[r][1]['launches'] for r in sorted(outs)]}, fused_match (tracker) "
                  f"{[outs[r][1]['tracker_launches'] for r in sorted(outs)]}; "
                  f"{time.perf_counter() - t1:.2f} s with the ranks' start")
    print(f"[distributed] phase {time.perf_counter() - t0:.2f} s; {card_and_limit()}")
    return launches, tracker_launches, b32


def phase_e2e(dev, card: str) -> None:
    """Phase 17: ``bench.e2e_frames`` on 1080p frames of one planted person,
    decode, annotation and encode left out; then both variants on the card
    and on the CPU on two batches of small frames."""
    t0 = time.perf_counter()
    frames, plants = bench.haar_bgr_frames(E2E_FRAMES, bench.SIZES["1080p"], E2E_SEED)
    fused_match.launches = gallery_match.launches = 0
    out = bench.e2e_frames(frames, batch=E2E_BATCH, max_frames=E2E_FRAMES, device=dev)
    check(fused_match.launches == 0 and gallery_match.launches == 0,
          "the end-to-end loop launches no hand-written kernel")
    print(f"[e2e] bench.e2e_frames, {E2E_FRAMES} BGR 1080p frames of one person, batch "
          f"{E2E_BATCH}: {json.dumps(out)}; {time.perf_counter() - t0:.2f} s")
    check(out.get("e2e_left_out") == ["decode", "annotate", "encode"], "the stages left out")
    check(out.get("e2e_train_crops", 0) >= 4, f"training crops: {out.get('e2e_train_crops')}")
    for variant in ("haar", "ncc"):
        check(out[f"e2e_{variant}_frames"] == E2E_FRAMES, f"{variant}: every frame")
    check(out["e2e_haar_detected"] == E2E_FRAMES, "the Haar variant detects in every frame")
    # The boxes behind those detections: the same detector on the same gray
    # frames, batch by batch, each frame's largest box the planted face.
    det = haar.HaarDetector(device=dev)
    for i in range(0, E2E_FRAMES, E2E_BATCH):
        gray = bgr_to_gray_exact(torch.from_numpy(frames[i:i + E2E_BATCH]).to(dev))
        for j, boxes in enumerate(det.detect_multi_scale_batch(gray)):
            check(bool(boxes) and len(bench.haar_planted_boxes(
                [max(boxes, key=lambda b: b[2] * b[3])], plants[i + j])) == 1,
                f"frame {i + j}: largest box {boxes} is not the planted face {plants[i + j]}")

    # The card against the CPU, both variants, over two batches: small
    # frames, since a 1080p Haar frame takes seconds on the CPU.
    small, _ = bench.haar_bgr_frames(2 * E2E_BATCH, E2E_CPU_SIZE, E2E_SEED, sides=(60, 120))
    runs = {name: bench.e2e_frames(small, batch=E2E_BATCH, device=where)
            for name, where in (("card", dev), ("cpu", torch.device("cpu")))}
    keys = ["e2e_train_crops"] + [f"e2e_{v}_{k}" for v in ("haar", "ncc")
                                  for k in ("frames", "detected", "recognized")]
    for key in keys:
        check(runs["card"][key] == runs["cpu"][key],
              f"{key}: card {runs['card'][key]}, CPU {runs['cpu'][key]}")
    print(f"[e2e] every frame's planted face detected; training crops {out['e2e_train_crops']}; "
          f"frames/s haar {out['e2e_haar_fps']}, ncc {out['e2e_ncc_fps']} (host clock, gray, "
          f"detection, crops, recognition; no decode, annotation or encode); on two batches of "
          f"{E2E_CPU_SIZE[0]}x{E2E_CPU_SIZE[1]} frames the card's "
          + ", ".join(f"{k} {runs['card'][k]}" for k in keys)
          + f" equal the CPU's; phase {time.perf_counter() - t0:.2f} s; {card_and_limit()}")


def main() -> int:
    if sys.argv[1:2] == ["--distributed-worker"]:
        return distributed_worker(*sys.argv[2:4])
    dev = phase_environment()
    card = torch.cuda.get_device_name(0)
    hmma = phase_build()
    fused = phase_kernel_vs_plain(dev)
    fused_launches = phase_slice(dev, card)
    torch.cuda.empty_cache()
    gallery = phase_gallery_vs_plain(dev)
    torch.cuda.empty_cache()
    gallery_launches, n1m = phase_gallery_slice(dev, card)
    torch.cuda.empty_cache()
    by_path = {"tracker": fused_launches}
    by_path["headline"], by_path["geom256"], g256 = phase_headline(dev, card)
    torch.cuda.empty_cache()
    by_path["scan"] = phase_scan(dev, card)
    torch.cuda.empty_cache()
    phase_detect(dev, card)
    by_path["multiscan"], d16384 = phase_multiscan(dev, card)
    torch.cuda.empty_cache()
    phase_haar(dev, card)
    phase_haar_pipeline(dev, card)
    phase_ccoeff(dev, card)
    phase_enhanced(dev, card)
    torch.cuda.empty_cache()
    by_path["cli_bench"] = phase_flow(dev, card)
    torch.cuda.empty_cache()
    gallery_by_path = {"large_gallery": gallery_launches}
    gallery_by_path["distributed"], by_path["tracker_distributed"], b32 = phase_distributed(
        dev, card)
    torch.cuda.empty_cache()
    phase_e2e(dev, card)
    print(json.dumps({"kernels": [
        {**KERNELS["fused_match"], "launches": sum(by_path.values()),
         "launches_by_path": by_path, **fused, "d16384": d16384, "b768_d16384": g256,
         "b32_d9216": b32, "hmma": hmma["fused_match"]},
        {**KERNELS["gallery_match"], "launches": sum(gallery_by_path.values()),
         "launches_by_path": gallery_by_path, **gallery, "n_1048573": n1m,
         "hmma": hmma["gallery_match"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
