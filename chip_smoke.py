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
4. the tracker slice: ``tracker_assets`` at 1080p with 64 streams and 8
   frame batches (seed 4), a snapshot-PCA model trained on the card, then
   8 ``process_batch`` steps and one 8-frame ``process_window``; every
   position and gallery row must be the planted one, and the kernel's
   launch count must show that both paths went through it;
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
   of a 969 x 4096, k = 100 PCA training.  Every planted offset and
   gallery row must be exact and the kernel must have been launched;
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
    and the bound (``d16384`` in the JSON line).

The line before the last is a JSON object describing each kernel, with
its time, its plain version's, ``library_ms``, its HMMA counts and
``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and
its operations over the published dense peak of their type (fp32 67,
TF32 495, bf16 989 TFLOP/s; float32 products count as three TF32
products, the 3xTF32 both kernels run).  For the fused kernel ``ms``,
``plain_ms`` and ``library_device_ms`` are device-only (CUDA graph)
times, and ``event_loop_ms``, ``plain_event_loop_ms`` and ``library_ms``
the event-loop ones.  The last line is ``{"ok": true, "device":
{...}}``.  Any failed check raises,
so the script exits nonzero without that line, as it does when PyTorch
sees no CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch import bench, device as port_device
from face_detection_recognization_pca_tpu_torch.detect.template import TemplateDetector
from face_detection_recognization_pca_tpu_torch.io.artifacts import save_model_v1
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    DetectionFile,
    DetectionRecord,
    write_detection_json,
)
from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta
from face_detection_recognization_pca_tpu_torch.linalg.pca import snapshot_pca
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import (
    recognize,
    to_artifact,
    train_v1,
)
from face_detection_recognization_pca_tpu_torch.ops import _build
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
    dp_recognize,
    make_mesh,
    multichip_train_step,
    sharded_gallery_match,
    snapshot_pca_sharded,
)
from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
    MultiStreamRecognizer,
)
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear
from face_detection_recognization_pca_tpu_torch.pipeline.scan_app import (
    scan_batches_multimodel,
    scan_frames_multimodel,
)
from face_detection_recognization_pca_tpu_torch.pipeline.tracked_scan import (
    scan_batches_tracked,
)

CONF_ATOL = 1e-5  # float32 sums in another order than cuBLAS's; cosines ~1
CONF_ATOL_BF16 = 2e-3  # bf16 operands, against plain with the same rounding
NEAR_TIE = 1e-5  # a differing id on random data: plain cosines this close
STREAMS, BATCHES, SEED = 64, 8, 4
HEADLINE_STREAMS, HEADLINE_BATCHES = 16, 32
SCAN_FRAMES, SCAN_BATCH, SCAN_SEED, SCAN_PERSON = 256, 16, 7, "planted_person"
DETECT_BATCH, DETECT_TEMPLATES, DETECT_SEED = 16, 8, 3
MULTISCAN_FRAMES, MULTISCAN_BATCH, MULTISCAN_SEED, MULTISCAN_SIDE = 64, 16, 5, 128
GALLERY_B, GALLERY_K, GALLERY_N, GALLERY_SEED = 1024, 128, 1_048_573, 9
JAX_SHAPE_N = 131072  # the JAX package's per-chip target (bench_large_gallery)
TRAIN_N, TRAIN_SIDE, TRAIN_K, TRAIN_SEED = 2048, 64, 128, 6
# multichip_train_step against the dense snapshot_pca, both float32 on the
# card: eigenvalues within 1e-4 of the largest, and the rank-128
# reconstruction proj @ components (well conditioned: component 128 stands
# 13x above the noise, bench.structured_faces) within 1e-3 of its largest.
EIG_RTOL, RECON_RTOL = 1e-4, 1e-3
# One H100 SXM, published dense peaks at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
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
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
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


def phase_environment() -> torch.device:
    dev = port_device.require_cuda()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
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
    frames, gallery_images, face, plants = bench.tracker_assets(
        STREAMS, (h, w), BATCHES, SEED, dev
    )
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    model.labels = torch.arange(bench.GALLERY_N, dtype=torch.int32, device=dev) % 4
    msr = MultiStreamRecognizer(model, face, window=bench.WIN)
    boxes0 = np.stack(
        [plants[0, :, 1], plants[0, :, 0], np.zeros(STREAMS), np.zeros(STREAMS)], axis=1
    ).astype(np.int32)
    torch.cuda.synchronize()
    print(f"[slice] assets + training {time.perf_counter() - t0:.2f} s; frames "
          f"{tuple(frames.shape)} {frames.numel() * 4 / 1e9:.2f} GB on {card}")

    def run_batches():
        state = msr.init_state(STREAMS, (h, w), boxes0)
        outs = []
        for f in range(BATCHES):
            out, state = msr.process_batch(frames[f], state)
            outs.append(out)
        torch.cuda.synchronize()
        return outs, state

    def run_window():
        state = msr.init_state(STREAMS, (h, w), boxes0)
        out, state = msr.process_window(frames, state)
        torch.cuda.synchronize()
        return out, state

    fused_match.launches = gallery_match.launches = 0
    outs, state_b = run_batches()
    wout, state_w = run_window()
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

    # Step time, for information: host clock around synchronised runs.
    best_b = best_w = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_batches()
        best_b = min(best_b, (time.perf_counter() - t0) / BATCHES)
        t0 = time.perf_counter()
        run_window()
        best_w = min(best_w, (time.perf_counter() - t0) / BATCHES)
    print(f"[slice] step ms (best of 3, {STREAMS} streams 1080p): process_batch "
          f"{best_b * 1e3:.3f}, process_window {best_w * 1e3:.3f} per frame step; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    return launches


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


def phase_gallery_vs_plain(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = _gallery_cases(dev, gen)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    results = {}
    for name, (feats, gallery_t, gnorm, dt, random) in cases.items():
        idx_k, best_k = gallery_match(feats, gallery_t, gnorm, operand_dtype=dt)
        idx_p, best_p = _gallery_match_plain(feats, gallery_t, gnorm, operand_dtype=dt)
        torch.cuda.synchronize()
        results[name] = (idx_k, best_k)
        differ = (idx_k != idx_p).nonzero()[:, 0]
        gap = 0.0
        if len(differ):
            check(random, f"{name}: ids differ at {differ.tolist()[:8]}")
            cos_k = _plain_cos(feats[differ], gallery_t, gnorm, idx_k[differ], dt)
            cos_p = _plain_cos(feats[differ], gallery_t, gnorm, idx_p[differ], dt)
            gap = float((cos_k - cos_p).abs().max())
            check(gap <= NEAR_TIE, f"{name}: differing ids are no near-ties (gap {gap})")
        err = float((best_k - best_p).abs().max())
        errs[dt] = max(errs[dt], err)
        atol = CONF_ATOL if dt == torch.float32 else CONF_ATOL_BF16
        print(f"[gallery] {name}: B={feats.shape[0]} k={feats.shape[1]} "
              f"N={gallery_t.shape[1]} {str(dt)[6:]}: {len(differ)} near-tie ids "
              f"(max cos gap {gap:.3g}), max|dbest| {err:.3g}")
        check(err <= atol, f"{name}: best error {err} > {atol}")

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


def phase_gallery_slice(dev, card: str) -> tuple:
    t0 = time.perf_counter()
    feats, gallery, labels, planted = bench.large_gallery_assets(
        GALLERY_B, GALLERY_K, GALLERY_N, GALLERY_SEED, dev)
    want = labels[torch.from_numpy(planted).to(dev)]
    galleries = {torch.float32: gallery, torch.bfloat16: gallery.to(torch.bfloat16)}
    images = bench.structured_faces(TRAIN_N, TRAIN_SIDE, TRAIN_K, TRAIN_SEED, dev)
    model, _ = train_v1(images, n_components=TRAIN_K)
    model.labels = torch.arange(TRAIN_N, dtype=torch.int32, device=dev) % 16
    noise = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    crops = (images[:GALLERY_B] + 2 * torch.randn(GALLERY_B, TRAIN_SIDE ** 2, generator=noise,
                                                  device=dev)).reshape(-1, TRAIN_SIDE, TRAIN_SIDE)
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
    recon_d = dense.projected @ dense.components
    scale = float(recon_d.abs().max())
    for m, (ids, conf, eigval) in trained.items():
        comps, _, proj, _ = snapshot_pca_sharded(meshes[m], images, TRAIN_K)
        eig_err = float((eigval - dense.eigenvalues).abs().max() / dense.eigenvalues[0])
        recon_err = float((proj @ comps - recon_d).abs().max()) / scale
        print(f"[slice2] multichip_train_step {m}: ids {sorted(set(ids.tolist()))}, min conf "
              f"{float(conf.min()):.6f}, eigenvalue err {eig_err:.3g} of the largest, "
              f"reconstruction err {recon_err:.3g} of its largest")
        check(bool((ids == 0).all()) and float(conf.min()) > 0.999, f"{m}: probes self-match")
        check(bool((eigval[1:] <= eigval[:-1]).all()), f"{m}: eigenvalues descending")
        check(eig_err <= EIG_RTOL, f"{m}: eigenvalues vs dense {eig_err}")
        check(recon_err <= RECON_RTOL, f"{m}: reconstruction vs dense {recon_err}")
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


def phase_headline(dev, card: str) -> int:
    fused_match.launches = gallery_match.launches = 0
    t0 = time.perf_counter()
    result = bench.headline(streams=HEADLINE_STREAMS, t_frames=HEADLINE_BATCHES, device=dev)
    launches = fused_match.launches
    detail = result["detail"]
    print(f"[headline] {result['metric']}: {result['value']} {result['unit']}; self-check "
          f"{detail['self_check']} (planted offsets exact {detail['planted_offset_exact']}, "
          f"gallery row 0 {detail['planted_id_rate']}) over {detail['frames_per_dispatch']} "
          f"frames per dispatch; step {detail['step_ms']} ms (host clock, best of 3 windows of "
          f"20 dispatches); device {detail['device_ms']} ms in {detail['kernel_launches']} "
          f"kernels per dispatch (torch.profiler), busy share {detail['busy_share']}; "
          f"{detail['headline_tflops']} TFLOP/s by the closed form of "
          f"{detail['headline_mflops_per_frame']} MFLOP per frame; fused_match launches "
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
    return launches


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


def main() -> int:
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
    by_path = {"tracker": fused_launches, "headline": phase_headline(dev, card)}
    torch.cuda.empty_cache()
    by_path["scan"] = phase_scan(dev, card)
    torch.cuda.empty_cache()
    phase_detect(dev, card)
    by_path["multiscan"], d16384 = phase_multiscan(dev, card)
    print(json.dumps({"kernels": [
        {**KERNELS["fused_match"], "launches": sum(by_path.values()),
         "launches_by_path": by_path, **fused, "d16384": d16384, "hmma": hmma["fused_match"]},
        {**KERNELS["gallery_match"], "launches": gallery_launches, **gallery,
         "n_1048573": n1m, "hmma": hmma["gallery_match"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
