"""Self-checking workloads (ports of the JAX package's ``bench.py``).

The headline (``bench_headline``), the metric of record: recognized 1080p
frames per second per card for the fixed-window detect + recognize step.
T = 32 frame batches of S streams are flattened into one batch of
windows; every frame holds a planted face at a known offset and gallery
row 0 is that exact face (:func:`headline_assets`), so the step
(:func:`headline_scan`) must report every offset and row 0, or
:func:`headline` publishes 0 frames/s.  Its secondary is the wall time of
a PCA training at the reference's multi-person scale.

The tracker (``bench._tracker_assets``), BASELINE config 5: S video
streams of 1080p frames, each with a 96x96 planted face that drifts by
up to 2 px per frame batch, tracked by
:class:`..parallel.multistream.MultiStreamRecognizer` with a 192x192
search window.  Gallery row 0 is the exact planted face, so a correct
step reports every planted position and gallery row 0
(:func:`planted_exact`).

The large gallery (``bench_large_gallery``): probes that are noisy
copies of planted rows of a random gallery of up to a million rows
(:func:`large_gallery_assets`), matched by the streaming gallery kernel
and by its plain version (:func:`large_gallery`).

The full-frame detector (``bench_full_frame_detect``): every template at
every scale over the whole frame, a clean template planted at the centre
(:func:`full_frame_assets`, :func:`full_frame_detect`).

The multi-model scan: persons with distinct faces, a v2 model and two
templates each, planted in turn into uint8 BGR frames
(:func:`multimodel_scan_assets`), for
:func:`..pipeline.scan_app.scan_batches_multimodel`.

The Haar detector (``bench_haar``): noise frames, each holding one
synthetic face that the frontal-face cascade accepts (:func:`haar_face`)
at a seeded side and place (:func:`haar_assets`), through
:class:`..detect.haar.HaarDetector` blocking and pipelined
(:func:`haar_detect`); :func:`haar_bgr_frames` makes the same scenes as
uint8 BGR frames on the host for the apps that stand on the detector.

The CCOEFF detector (``detect/ccoeff``): noise frames each holding one
clean :func:`_person_face`, against noisy copies of every person's face
as templates (:func:`ccoeff_assets`, :func:`ccoeff_detect`).  The
enhanced ensemble: :func:`haar_bgr_frames` scenes of several persons at
seeded sides, to train on their detected crops and to scan
(:func:`enhanced_assets`).  The reference's flow, detect -> train ->
recognize: :func:`pipeline_assets`.

The multi-chip dryrun (``__graft_entry__.dryrun_multichip``): the sharded
training step on a (data x model) mesh, across processes when a process
group is configured (:func:`dryrun_multichip`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import exact_float32, resolve_device
from face_detection_recognization_pca_tpu_torch.linalg.pca import snapshot_pca
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import (
    to_artifact,
    train_v1,
    train_v2,
)
from face_detection_recognization_pca_tpu_torch.ops.fused_match import (
    fused_match,
    linearize_model,
)
from face_detection_recognization_pca_tpu_torch.ops.gallery_match import (
    _gallery_match_plain,
    gallery_match,
)
from face_detection_recognization_pca_tpu_torch.ops.preprocess import preprocess_crops
from face_detection_recognization_pca_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_multihost,
)
from face_detection_recognization_pca_tpu_torch.parallel.mesh import make_mesh
from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
    MultiStreamRecognizer,
    StepOperands,
    locate_and_match,
    step_operands,
)
from face_detection_recognization_pca_tpu_torch.parallel.sharding import multichip_train_step

SIZES = {"1080p": (1080, 1920), "720p": (720, 1280), "544p": (544, 960)}
WIN = 192  # search window side (guided scanner: 1.5-2x face box)
TPL = 96  # template / face box side
GALLERY_N = 256
N_COMPONENTS = 64
# One H100 SXM at 700 W, published dense peaks (NVIDIA's data sheet): HBM
# bytes/s, and FLOP/s by operand type (float32 outside the tensor cores,
# TF32 and bf16 on them).  A roofline share is taken against these.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def _planted_face(rng: np.random.Generator, tpl: int) -> np.ndarray:
    """A structured (tpl, tpl) float32 "face": smooth blobs plus N(0, 8)."""
    yy, xx = np.mgrid[0:tpl, 0:tpl].astype(np.float32) / tpl
    return (
        140
        + 60 * np.sin(6.28 * yy * 2.1)
        + 40 * np.cos(6.28 * xx * 1.7)
        + rng.normal(0, 8, (tpl, tpl))
    ).astype(np.float32)


def _gallery_images(rng: np.random.Generator, face: np.ndarray, n: int) -> np.ndarray:
    """(n, tpl * tpl) float32 training images: row 0 the exact face, the
    rest copies rolled by up to 2 px with N(0, 4) noise."""
    gal = np.stack(
        [
            np.roll(face, (rng.integers(-2, 3), rng.integers(-2, 3)), (0, 1)).reshape(-1)
            + rng.normal(0, 4, face.size)
            for _ in range(n)
        ]
    ).astype(np.float32)
    gal[0] = face.reshape(-1)
    return gal


def _noise_frames(n: int, size: Tuple[int, int], face: np.ndarray, plants: np.ndarray,
                  seed: int, device: torch.device) -> torch.Tensor:
    """(n, H, W) float32 frames made on ``device``: noise ``110 + 25 N(0, 1)``
    from a ``torch.Generator`` there seeded with ``seed``, with ``face``
    written into frame i at ``plants[i]`` = (y, x)."""
    h, w = size
    tpl = face.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frames = torch.empty((n, h, w), dtype=torch.float32, device=device)
    frames.normal_(110.0, 25.0, generator=gen)
    plants = torch.from_numpy(plants.reshape(-1, 2)).to(device)
    ar = torch.arange(tpl, device=device)
    rows = (plants[:, 0, None] + ar)[:, :, None]
    cols = (plants[:, 1, None] + ar)[:, None, :]
    index = torch.arange(n, device=device)[:, None, None]
    frames[index, rows, cols] = torch.from_numpy(face).to(device)
    return frames


def headline_assets(
    streams: int,
    size: Tuple[int, int],
    device: torch.device,
    gallery_n: int = GALLERY_N,
    k: int = N_COMPONENTS,
    seed: int = 0,
    win: int = WIN,
    tpl: int = TPL,
    t_frames: int = 32,
):
    """``(frames, (win_y, win_x), model, face, offs)`` for the headline.

    ``frames``: (t_frames, S, H, W) float32 on ``device``, noise from a
    seeded ``torch.Generator`` there (:func:`_noise_frames`), each with the
    face planted at ``(win_y + offs[i, 0], win_x + offs[i, 1])``, i the
    flat frame index; ``(win_y, win_x)`` is the centred search window.
    ``model`` is a snapshot-PCA model trained on ``device`` on ``gallery_n``
    jittered copies of the face, row 0 the exact face.  ``face`` (tpl, tpl)
    and ``offs`` (t_frames * S, 2) are numpy.  The face, the offsets and
    the training images come from ``np.random.default_rng(seed)`` in the
    JAX package's order of draws, so they equal its ``_synth_assets``'s;
    the frames' noise is this package's own."""
    h, w = size
    rng = np.random.default_rng(seed)
    face = _planted_face(rng, tpl)
    win_y, win_x = (h - win) // 2, (w - win) // 2
    offs = rng.integers(0, win - tpl, (t_frames * streams, 2)).astype(np.int32)
    frames = _noise_frames(
        t_frames * streams, size, face, offs + np.array([win_y, win_x], np.int32), seed, device
    ).reshape(t_frames, streams, h, w)
    images = torch.from_numpy(_gallery_images(rng, face, gallery_n)).to(device)
    model, _ = train_v1(images, n_components=k)
    return frames, (win_y, win_x), model, face, offs


def headline_scan(frames_t: torch.Tensor, ops: StepOperands, win_y: int, win_x: int):
    """One dispatch of the headline: the fixed ``win`` x ``win`` window at
    ``(win_y, win_x)`` of all ``(T, S, H, W)`` frames, the time axis
    flattened into the batch, through the tracker's step math
    (:func:`..parallel.multistream.locate_and_match`: the tracker's step
    with a fixed origin and no feedback).  Returns ``(ids, conf, tm_conf,
    x, y)`` over the T * S frames, x and y in frame coordinates.  The
    matmuls run in full float32 whatever the caller's TF32 setting."""
    t, s = frames_t.shape[:2]
    win = ops.win
    windows = frames_t[:, :, win_y:win_y + win, win_x:win_x + win].reshape(t * s, win, win)
    with exact_float32():
        ids, conf, tm_conf, ly, lx = locate_and_match(windows, windows.mean(), ops)
    return ids, conf, tm_conf, lx + win_x, ly + win_y


def headline_flops_per_frame(k: int = N_COMPONENTS, gallery_n: int = GALLERY_N,
                             win: int = WIN, tpl: int = TPL) -> float:
    """Closed-form FLOPs of one frame of the headline step, the JAX
    package's count unchanged (so the two packages' TFLOP/s divide the
    same work, whichever way each computes it):

    - DFT-matmul circular correlation: forward 6 matmuls of (n,n)@(n,n) =
      12n^3, elementwise complex multiply ~6n^2, inverse 4 matmuls
      (o,n)@(n,n) = 8on^2 plus 2 matmuls against (o,n) partials = 4o^2n.
    - Banded box-filter sums s1, s2: 2n^2 o + 2n o^2 each; plus 2n^2
      elementwise (centering, square).
    - Crop extraction counted as the two one-hot selection matmuls of the
      JAX step, 2tn^2 + 2nt^2 (this package gathers instead).
    - Linearized projection 2 t^2 k; gallery dots 2kN + 3N norms.
    """
    n, o, t = win, win - tpl + 1, tpl
    corr = 12 * n**3 + 6 * n**2 + 8 * o * n**2 + 4 * o**2 * n
    banded = 2 * (2 * n**2 * o + 2 * n * o**2) + 2 * n**2
    crops = 2 * t * n**2 + 2 * n * t**2
    recog = 2 * (t * t) * k + 2 * k * gallery_n + 3 * gallery_n
    return float(corr + banded + crops + recog)


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
    face = _planted_face(rng, TPL)

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

    frames = _noise_frames(batches * streams, size, face, plants, seed, device)
    frames = frames.reshape(batches, streams, h, w)
    gal_imgs = _gallery_images(rng, face, GALLERY_N)
    return frames, torch.from_numpy(gal_imgs).to(device), face, plants


def scan_assets(n_frames: int, size: Tuple[int, int], seed: int, step: int = 3):
    """``(frames, gallery_images, face, plants)`` for the tracked scan of
    one video, all numpy on the host, as a decoder would hand them over.

    ``frames``: (n_frames, H, W) uint8, uniform noise in [60, 160] with
    the uint8 ``face`` (96, 96) written at ``plants[i]`` = (y, x), which
    starts in the interior and drifts by up to ``step`` px per frame.
    ``gallery_images``: (256, 96*96) float32 training images whose row 0
    is the exact face.  Everything comes from
    ``np.random.default_rng(seed)``."""
    h, w = size
    rng = np.random.default_rng(seed)
    face = np.clip(np.rint(_planted_face(rng, TPL)), 0, 255).astype(np.uint8)
    pos = np.array([rng.integers(WIN, h - WIN), rng.integers(WIN, w - WIN)])
    drift = rng.integers(-step, step + 1, (n_frames, 2))
    plants = np.zeros((n_frames, 2), np.int32)
    for i in range(n_frames):
        plants[i] = pos
        pos = np.clip(pos + drift[i], 0, [h - TPL, w - TPL])
    frames = rng.integers(60, 161, (n_frames, h, w), dtype=np.uint8)
    for frame, (y, x) in zip(frames, plants):
        frame[y:y + TPL, x:x + TPL] = face
    return frames, _gallery_images(rng, face.astype(np.float32), GALLERY_N), face, plants


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


def tracker_recognizer(
    streams: int,
    size: Tuple[int, int],
    batches: int,
    seed: int,
    device: torch.device,
    mesh=None,
    model=None,
):
    """``(msr, frames, plants, boxes0, model)`` for the tracker: the
    :func:`tracker_assets` frames and plants, a snapshot-PCA model trained
    on ``device`` on the gallery images with labels ``arange(256) % 4``
    (or ``model`` when given), the
    :class:`..parallel.multistream.MultiStreamRecognizer` of it (over
    ``mesh`` when given), and the first plants as (x, y, 0, 0) boxes for
    ``init_state``."""
    frames, gallery_images, face, plants = tracker_assets(streams, size, batches, seed, device)
    if model is None:
        model, _ = train_v1(gallery_images, n_components=N_COMPONENTS)
        model.labels = torch.arange(GALLERY_N, dtype=torch.int32, device=device) % 4
    msr = MultiStreamRecognizer(model, face, window=WIN, mesh=mesh)
    boxes0 = np.stack(
        [plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)], axis=1
    ).astype(np.int32)
    return msr, frames, plants, boxes0, model


def tracker(
    streams: int = 64,
    size: str = "1080p",
    batches: int = 8,
    loops: int = 3,
    seed: int = 4,
    mesh=None,
    device: Optional[torch.device] = None,
) -> Dict[str, object]:
    """Throughput of the shipped tracker (port of ``bench_tracker``):
    :class:`..parallel.multistream.MultiStreamRecognizer` over ``streams``
    streams of :func:`tracker_assets` frames, whose planted faces drift
    by up to 2 px per frame batch, from the first plants on, so the
    tracker must re-centre to keep finding them.  ``device=None`` means
    the CUDA device; with ``mesh`` the streams are split over its data
    axis, across processes too (each process then runs this whole
    function).

    ``tracker_step_ms``: ``process_batch`` per frame step, host clock
    around a synchronised pass of ``batches`` steps, best of ``loops``
    passes after a first pass; ``tracker_window_step_ms``: the same for
    one ``process_window`` of all batches, best of ``max(3, loops)``.
    Each fps is 0 unless its first pass reported every planted (x, y)
    exactly and gallery row 0 everywhere.  The JAX function kept taking
    windows until it reached a target or 120 s passed, to outlast pauses
    of a remote TPU worker; a card has none, so this takes ``loops``."""
    device = resolve_device(device)
    h, w = SIZES[size]
    msr, frames, plants, boxes0, _ = tracker_recognizer(streams, (h, w), batches, seed,
                                                        device, mesh)

    def run_pass():
        state = msr.init_state(streams, (h, w), boxes0)
        outs = []
        for f in range(batches):
            out, state = msr.process_batch(frames[f], state)
            outs.append(out)
        _synchronize(device)
        return outs

    def run_window():
        out, _ = msr.process_window(frames, msr.init_state(streams, (h, w), boxes0))
        _synchronize(device)
        return out

    outs = run_pass()
    x, y, rows = ([o[key].cpu().numpy() for o in outs] for key in ("x", "y", "gallery_row"))
    ok_pos = bool(np.array_equal(x, plants[..., 1]) and np.array_equal(y, plants[..., 0]))
    ok_id = bool(np.all(np.stack(rows) == 0))
    conf = torch.stack([o["confidence"] for o in outs])
    dt = float("inf")
    for _ in range(loops):
        t0 = time.perf_counter()
        run_pass()
        dt = min(dt, (time.perf_counter() - t0) / batches)

    ok_w = planted_exact(run_window(), plants)
    dt_w = float("inf")
    for _ in range(max(3, loops)):
        t0 = time.perf_counter()
        run_window()
        dt_w = min(dt_w, (time.perf_counter() - t0) / batches)
    ok = ok_pos and ok_id
    return {
        "tracker_fps": streams / dt if ok else 0.0,
        "tracker_step_ms": dt * 1e3,
        "tracker_window_fps": streams / dt_w if ok_w else 0.0,
        "tracker_window_step_ms": dt_w * 1e3,
        "tracker_window_planted_exact": ok_w,
        "tracker_windows": loops,
        "tracker_streams": streams,
        "tracker_batches": batches,
        "tracker_size": size,
        "tracker_planted_pos_exact": ok_pos,
        "tracker_planted_id_exact": ok_id,
        "tracker_min_conf": float(conf.min()),
        "tracker_engine": "parallel.multistream.MultiStreamRecognizer",
    }


def large_gallery_assets(b: int, k: int, n: int, seed: int, device: torch.device):
    """``(feats, gallery, labels, planted)`` for a large-gallery match.

    ``gallery`` (n, k) float32 is standard normal from
    ``np.random.default_rng(seed)``; ``labels`` (n,) int32 are
    ``row // 8``; ``planted`` (b,) numpy holds distinct gallery rows, and
    ``feats`` (b, k) float32 are those rows plus N(0, 0.05^2) noise.  At
    k = 128 a probe scores about 0.999 against its planted row and under
    about 0.5 against any other, so every probe must be named by
    ``labels[planted]``.  The tensors land on ``device``."""
    rng = np.random.default_rng(seed)
    gallery = rng.standard_normal((n, k), dtype=np.float32)
    planted = rng.choice(n, size=b, replace=False)
    feats = gallery[planted] + np.float32(0.05) * rng.standard_normal((b, k), dtype=np.float32)
    labels = (np.arange(n) // 8).astype(np.int32)
    return (
        torch.from_numpy(feats).to(device),
        torch.from_numpy(gallery).to(device),
        torch.from_numpy(labels).to(device),
        planted,
    )


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around
    ``iters`` calls after ``warmup`` calls, then a synchronise."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn: Callable[[], object], calls: int = 50, replays: int = 5,
                  warmup: int = 3) -> float:
    """Device-only ms per call of ``fn``: ``calls`` calls captured in one
    CUDA graph (after ``warmup`` calls on the capturing side stream),
    replayed ``replays`` times between CUDA events.  The host's Python
    and launch costs, which :func:`cuda_time_ms` also counts, are left
    out; the gaps between the graph's kernels stay in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def time_in_turns(fns: Mapping[str, Callable[[], object]], order: Sequence[str],
                  loop_iters: int = 200, graph_calls: int = 50) -> Dict[str, Dict[str, list]]:
    """ms per call of each of ``fns``, taken in ``order`` (a name may
    repeat, as in plain, kernel, library, library, kernel, plain): first
    :func:`cuda_time_ms` over ``loop_iters`` calls (``"loop"``: host and
    card), then :func:`cuda_graph_ms` over ``graph_calls`` (``"device"``:
    the card alone).  Returns {"loop" | "device": {name: [ms, ...]}}."""
    out = {"loop": {name: [] for name in fns}, "device": {name: [] for name in fns}}
    for name in order:
        out["loop"][name].append(cuda_time_ms(fns[name], loop_iters, 10))
    for name in order:
        out["device"][name].append(cuda_graph_ms(fns[name], graph_calls))
    return out


def device_kernels(prof) -> list:
    """(name, device us summed, calls) of every GPU kernel in a
    ``torch.profiler`` trace, the longest first."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key, us, evt.count))
    return sorted(rows, key=lambda r: -r[1])


def traced_kernels(fn: Callable[[], object], calls: int) -> list:
    """(name, device us per call, launches per call) of every GPU kernel
    that ``calls`` eager calls of ``fn`` ran, the longest first, from a
    ``torch.profiler`` trace taken after one untraced call; empty when the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(key, us / calls, count / calls) for key, us, count in device_kernels(prof) if us > 0]


def kernel_families(rows: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Device ms per family of GPU kernels, from :func:`traced_kernels`
    rows, by name: cuFFT's (``fft``), GEMMs (``matmul``), top-k and sorts
    (``topk``), reductions, elementwise kernels, copies, and the rest."""
    words = (
        ("fft", ("fft",)),
        ("topk", ("topk", "sort", "radix")),
        ("matmul", ("gemm", "cutlass", "xmma", "cublas")),
        ("reduce", ("reduce",)),
        ("elementwise", ("elementwise", "vectorized")),
        ("copy", ("memcpy", "memset", "copy")),
    )
    out: Dict[str, float] = {}
    for name, us, _ in rows:
        low = name.lower()
        family = next((fam for fam, keys in words if any(k in low for k in keys)), "other")
        out[family] = out.get(family, 0.0) + us / 1e3
    return out


def profiler_ms(fn: Callable[[], object], calls: int = 50) -> Union[float, None]:
    """Kernel time per call of ``fn`` summed by ``torch.profiler`` over
    ``calls`` eager calls, or None when the trace holds no device time."""
    rows = traced_kernels(fn, calls)
    return sum(us for _, us, _ in rows) / 1e3 if rows else None


def large_gallery(
    b: int = 1024, k: int = 128, n: int = 131072, iters: int = 10, seed: int = 9,
    device: torch.device = torch.device("cuda"),
) -> Dict[str, object]:
    """The streaming gallery kernel against its plain version, float32 and
    bfloat16 operands, on :func:`large_gallery_assets` (port of
    ``bench_large_gallery``).

    Times are CUDA-event ms per call, taken as plain, kernel, kernel,
    plain and averaged per version.  ``*_ids_agree`` is the share of
    probes on which kernel and plain pick the same row, ``*_planted`` the
    share on which the kernel picks the planted row.  Needs a CUDA
    device; it raises on any other."""
    if device.type != "cuda":
        raise ValueError(f"large_gallery times a CUDA device, got {device}")
    feats, gallery, _, planted = large_gallery_assets(b, k, n, seed, device)
    planted = torch.from_numpy(planted).to(device)
    out: Dict[str, object] = {
        "card": torch.cuda.get_device_name(device),
        "shape": f"B={b} k={k} N={n}",
        "gflop_per_call": 2.0 * b * k * n / 1e9,
    }
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        g = gallery.to(dt)
        gnorm = torch.linalg.vector_norm(g, dim=1, dtype=torch.float32)

        def kernel():
            return gallery_match(feats, g.T, gnorm, operand_dtype=dt)

        def plain():
            return _gallery_match_plain(feats, g.T, gnorm, operand_dtype=dt)

        p1, k1, k2, p2 = (cuda_time_ms(fn, iters) for fn in (plain, kernel, kernel, plain))
        ids_k, best_k = kernel()
        ids_p, best_p = plain()
        out[f"{name}_kernel_ms"] = (k1 + k2) / 2
        out[f"{name}_plain_ms"] = (p1 + p2) / 2
        out[f"{name}_ids_agree"] = float((ids_k == ids_p).float().mean())
        out[f"{name}_planted"] = float((ids_k == planted).float().mean())
        out[f"{name}_max_abs_err"] = float((best_k - best_p).abs().max())
    return out


def structured_faces(n: int, side: int, rank: int, seed: int, device: torch.device):
    """``(n, side * side)`` float32 training images on ``device`` whose top
    ``rank`` principal components stand well apart: pixel level 110, plus
    ``rank`` orthonormal directions with standard deviations 60 * 0.985^i,
    plus N(0, 1) pixel noise, from ``np.random.default_rng(seed)``.  The
    gap between component ``rank`` and the noise keeps the top-``rank``
    subspace well conditioned, so two PCA runs that sum in other orders
    agree on it closely."""
    rng = np.random.default_rng(seed)
    d = side * side
    basis = np.linalg.qr(rng.standard_normal((d, rank)))[0]  # (d, rank)
    coeffs = rng.standard_normal((n, rank)) * (60.0 * 0.985 ** np.arange(rank))
    images = 110.0 + coeffs @ basis.T + rng.standard_normal((n, d))
    return torch.from_numpy(images.astype(np.float32)).to(device)


def dryrun_multichip(n_devices: int, n_hosts: int = 1,
                     device: Optional[Union[str, torch.device]] = None) -> None:
    """The sharded training step on an ``n_devices``-entry mesh (port of
    ``__graft_entry__.dryrun_multichip``).  Every entry is ``device`` (the
    CUDA device for ``None``), repeated as often as the mesh needs.

    ``n_hosts > 1`` asks for the multi-process path: where
    :func:`..parallel.distributed.initialize_multihost` finds a process
    group (or one is joined already), the ``n_devices`` entries are split
    evenly over its processes and :func:`..parallel.distributed.global_mesh`
    lays the data axis across them; without one it says so and continues
    in one process.  The model axis is the largest divisor of the entry
    count, of the feature dim and of the local entry count that still
    leaves a data axis, as in the JAX package.  Raises ``RuntimeError``
    where the step's self-checks fail; prints the JAX package's lines."""
    device = resolve_device(device)
    multihost = False
    if n_hosts > 1:
        if initialize_multihost():
            multihost = True
            world = torch.distributed.get_world_size()
            if n_devices % world:
                raise ValueError(f"{n_devices} entries do not split over {world} processes")
            print(f"multi-host: process {torch.distributed.get_rank()}/{world}, "
                  f"{n_devices} global devices")
        else:
            print(f"multi-host requested (n_hosts={n_hosts}) but no coordinator configured; "
                  "continuing single-host")
    local = n_devices // torch.distributed.get_world_size() if multihost else n_devices
    d = 64 * 64  # feature dim; the model axis must divide it
    model_par = 1
    for cand in range(min(max(n_devices // 2, 1), local), 0, -1):
        if n_devices % cand == 0 and d % cand == 0 and local % cand == 0:
            model_par = cand
            break
    data_par = n_devices // model_par
    if multihost:
        mesh = global_mesh(data=data_par, model=model_par, devices=[device] * local)
    else:
        mesh = make_mesh(data=data_par, model=model_par, devices=[device] * n_devices)

    rng = np.random.default_rng(11)
    n_imgs = 4 * max(data_par, 2)
    images = rng.normal(110, 20, (n_imgs, d)).astype(np.float32)
    probe_count = 2 * data_par
    probes = images[:probe_count].reshape(probe_count, 64, 64)
    with exact_float32():
        ids, conf, eigval = multichip_train_step(
            mesh, torch.from_numpy(images).to(device), torch.from_numpy(probes).to(device),
            n_components=4, face_shape=(64, 64))
    ids, conf, eig = ids.cpu().numpy(), conf.cpu().numpy(), eigval.cpu().numpy()
    if ids.shape != (probe_count,):
        raise RuntimeError(f"ids of shape {ids.shape}, want ({probe_count},)")
    if not np.all(np.diff(eig) <= 1e-6):
        raise RuntimeError(f"eigenvalues not descending: {eig}")
    if not conf.min() > 0.99:
        raise RuntimeError(f"self-match failed: {conf}")
    print(f"dryrun_multichip OK: mesh data={data_par} x model={model_par}, "
          f"ids={ids.tolist()}, min_conf={conf.min():.4f}")


def headline_self_check(out, offs: np.ndarray, win_y: int, win_x: int) -> Tuple[float, float]:
    """``(planted_offset_exact, planted_id_rate)`` of one :func:`headline_scan`
    result: the share of frames whose reported (x, y) equals the planted
    position, and the share whose gallery row is 0.  Both must be 1.0."""
    ids, _, _, x, y = (a.cpu().numpy().reshape(-1) for a in out)
    if x.shape[0] != offs.shape[0]:
        return 0.0, 0.0
    offset_exact = float(np.mean((x == win_x + offs[:, 1]) & (y == win_y + offs[:, 0])))
    return offset_exact, float(np.mean(ids == 0))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def headline(
    streams: int = 16,
    size: Tuple[int, int] = SIZES["1080p"],
    iters: int = 20,
    warmup: int = 3,
    win: int = WIN,
    tpl: int = TPL,
    t_frames: int = 32,
    with_train: bool = True,
    device: Optional[torch.device] = None,
) -> Dict[str, object]:
    """The metric of record (port of ``bench_headline``): frames per second
    per card of :func:`headline_scan` over ``t_frames`` x ``streams`` frames
    of ``size`` made by :func:`headline_assets`, plus the PCA-train
    secondary.  ``device=None`` means the CUDA device.

    A dispatch is timed by the host clock around one window of ``iters``
    synchronised dispatches after ``warmup`` dispatches (``step_ms``).  The
    fps is published only if the step recognized what was planted: every
    reported position equals the planted one and every gallery row is 0,
    over all frames; otherwise ``value`` is 0.  ``fused_match_launches``
    counts this function's launches of the fused kernel.  The secondary:
    ``snapshot_pca`` of 969 x 4096 float32 at k = 100 (the reference's
    multi-person scale), second call, synchronised."""
    device = resolve_device(device)
    launches0 = fused_match.launches
    frames, (win_y, win_x), model, face, offs = headline_assets(
        streams, size, device, win=win, tpl=tpl, t_frames=t_frames
    )
    ops = step_operands(linearize_model(model, (tpl, tpl)), face, win, device)

    def dispatch():
        return headline_scan(frames, ops, win_y, win_x)

    for _ in range(1 + warmup):
        out = dispatch()
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = dispatch()
    _synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    n_frames = t_frames * streams
    fps = n_frames / dt

    offset_exact, id_rate = headline_self_check(out, offs, win_y, win_x)
    ok = offset_exact == 1.0 and id_rate == 1.0
    conf, tm_conf = out[1], out[2]
    launches = fused_match.launches - launches0

    train_wall_s = 0.0
    if with_train:
        train_x = torch.from_numpy(
            np.random.default_rng(1).normal(120, 30, (969, 4096)).astype(np.float32)
        ).to(device)
        for _ in range(2):
            _synchronize(device)
            t1 = time.perf_counter()
            snapshot_pca(train_x, 100)
            _synchronize(device)
            train_wall_s = time.perf_counter() - t1

    flops_frame = headline_flops_per_frame(model.n_components, model.gallery.shape[0], win, tpl)
    name = next((key for key, hw in SIZES.items() if hw == tuple(size)), f"{size[0]}x{size[1]}")
    return {
        "metric": f"recognized {name} frames/sec/card (fused guided detect+project+match, "
                  f"{streams} streams)",
        "value": fps if ok else 0.0,
        "unit": "frames/s/card" if device.type == "cuda" else "frames/s on the CPU",
        "detail": {
            "streams": streams,
            "frames_per_dispatch": n_frames,
            "step_ms": dt * 1e3,
            "fused_match_launches": launches,
            "headline_mflops_per_frame": flops_frame / 1e6,
            "min_pca_conf": float(conf.min()),
            "min_tm_conf": float(tm_conf.min()),
            "planted_offset_exact": offset_exact,
            "planted_id_rate": id_rate,
            "self_check": "ok" if ok else "FAILED (fps zeroed)",
            "pca_train_wall_s_969x4096_k100": train_wall_s,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        },
    }


def headline_geom256(
    streams: int = 24,
    iters: int = 20,
    size: Tuple[int, int] = SIZES["1080p"],
    t_frames: int = 32,
    device: Optional[torch.device] = None,
) -> Dict[str, object]:
    """The headline step at window 256 and template 128 (port of
    ``bench_headline_geom256``): :func:`headline` with those sides, no PCA
    training, under ``g256_`` keys, so the metric of record keeps the
    192 / 96 geometry.  The same planted-exact self-check zeroes
    ``g256_fps``.  ``device=None`` means the CUDA device."""
    out = headline(streams=streams, size=size, iters=iters, win=256, tpl=128,
                   t_frames=t_frames, with_train=False, device=device)
    d = out["detail"]
    return {
        "g256_fps": out["value"],
        "g256_step_ms": d["step_ms"],
        "g256_mflops_per_frame": d["headline_mflops_per_frame"],
        "g256_self_check": d["self_check"],
    }


def full_frame_assets(
    batch: int, size: Tuple[int, int], n_templates: int, seed: int, device: torch.device
):
    """``(frames, bank, plant)`` for the full-frame detector.

    ``bank``: ``n_templates`` templates of 128 x 128 for persons
    ``p0``..``p3`` in turn, each the clean structured template plus
    N(0, 6) noise from ``np.random.default_rng(seed)`` (the JAX package's
    order of draws, so the banks are equal).  ``frames``: (batch, H, W)
    float32 on ``device``, noise ``110 + 25 N(0, 1)`` from a seeded
    ``torch.Generator`` there, with the clean template written at
    ``plant`` = (y, x) = ``(h // 2 - 64, w // 2 - 64)``."""
    from face_detection_recognization_pca_tpu_torch.detect.template import TemplateBank

    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 128
    tpl = (140 + 60 * np.sin(6.28 * yy * 2.1) + 40 * np.cos(6.28 * xx * 1.7)).astype(np.float32)
    templates = [
        (f"p{i % 4}", np.clip(tpl + rng.normal(0, 6, tpl.shape), 0, 255).astype(np.uint8))
        for i in range(n_templates)
    ]
    bank = TemplateBank(templates, canonical_size=(128, 128), device=device)
    plant = (h // 2 - 64, w // 2 - 64)
    plants = np.tile(np.array(plant, np.int32), (batch, 1))
    return _noise_frames(batch, size, tpl, plants, seed, device), bank, plant


def full_frame_detect(
    batch: int = 16,
    size: Tuple[int, int] = SIZES["544p"],
    n_templates: int = 8,
    iters: int = 5,
    seed: int = 3,
    device: Optional[torch.device] = None,
) -> Dict[str, object]:
    """Full-frame fused-NCC detection throughput (port of
    ``bench_full_frame_detect``): every template x scale over the WHOLE
    frame of :func:`full_frame_assets`.  ``device=None`` means the CUDA
    device.

    Two clocks.  ``fps``: :meth:`TemplateDetector.detect_fused_batch` end
    to end (device work, one download, host box selection), best of
    ``iters``.  ``device_fps``: ``iters`` device halves queued back to
    back and waited for once -- what a consumer that overlaps the
    download and the selection with the next batch pays.  ``detections``
    is the last end-to-end call's result, ``parity`` is
    :meth:`TemplateDetector.detect_parity` on frame 0, ``plant`` the
    planted (y, x) and ``template_threshold`` the detector's gate."""
    from face_detection_recognization_pca_tpu_torch.detect.template import TemplateDetector

    device = resolve_device(device)
    frames, bank, plant = full_frame_assets(batch, size, n_templates, seed, device)
    det = TemplateDetector(bank)
    out = det.detect_fused_batch(frames)  # warm-up: masks, FFT plans
    dt = float("inf")
    for _ in range(iters):
        _synchronize(device)
        t0 = time.perf_counter()
        out = det.detect_fused_batch(frames)
        dt = min(dt, time.perf_counter() - t0)

    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        det.detect_fused_device(frames)
    _synchronize(device)
    dt_dev = (time.perf_counter() - t0) / iters
    return {
        "fps": batch / dt,
        "ms_per_batch": dt * 1e3,
        "device_fps": batch / dt_dev,
        "device_ms_per_batch": dt_dev * 1e3,
        "size": tuple(size),
        "batch": batch,
        "templates": n_templates,
        "detected": sum(1 for d in out if d),
        "detections": out,
        "parity": det.detect_parity(frames[0]),
        "plant": plant,
        "template_threshold": det.config.template_threshold,
    }


def _person_face(person: int, side: int) -> np.ndarray:
    """A structured (side, side) uint8 face whose stripes differ per
    person in frequency and direction, so two persons' faces correlate
    weakly."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    fy, fx = 1.3 + 0.9 * person, 4.1 - 0.8 * person
    face = 128 + 55 * np.sin(6.28 * (fy * yy + 0.3 * person * xx)) + 45 * np.cos(6.28 * fx * xx)
    return np.clip(np.rint(face), 0, 255).astype(np.uint8)


def multimodel_scan_assets(
    n_frames: int,
    size: Tuple[int, int],
    seed: int,
    device: torch.device,
    persons: int = 4,
    side: int = 128,
    gallery_n: int = GALLERY_N,
    k: int = N_COMPONENTS,
    face_shape: Tuple[int, int] = (64, 64),
    step: int = 3,
):
    """``(frames, stack, bank, plants, names, models)`` for the
    multi-model scan, everything from ``np.random.default_rng(seed)``.

    ``persons`` persons ``person0``.. with :func:`_person_face` faces of
    ``side`` x ``side``.  Each gets a :func:`train_v2` model trained on
    ``device`` (``face_shape``, ``k`` components, ``gallery_n`` training
    rows: row 0 the face exactly as the scan's preprocessing resizes it,
    the rest copies rolled by up to 2 px with N(0, 4) noise) and two
    templates (the face plus N(0, 6) noise), gathered into ``stack``
    (:class:`ModelStack`) and ``bank`` (:class:`TemplateBank`) with no
    file in between.  ``models`` are the persons' ``EigenfacesModel`` s.

    ``frames``: (n_frames, H, W, 3) uint8 BGR numpy, as a decoder hands
    them over: uniform noise in [60, 160] with person ``i % persons``'s
    face written gray (B = G = R) into frame i at ``plants[i]`` = (y, x).
    The position starts inside the frame and drifts by up to ``step`` px
    per frame inside the region that the detector's border strips (5% of
    each side) and corner squares (15%) leave clear."""
    from face_detection_recognization_pca_tpu_torch.detect.template import TemplateBank
    from face_detection_recognization_pca_tpu_torch.recognize.engine import ModelStack

    h, w = size
    rng = np.random.default_rng(seed)
    names = [f"person{p}" for p in range(persons)]
    faces = [_person_face(p, side) for p in range(persons)]
    artifacts, templates, models = [], [], []
    fh, fw = face_shape
    for name, face in zip(names, faces):
        bgr = torch.from_numpy(np.repeat(face[None, :, :, None], 3, axis=3)).to(device)
        row0 = preprocess_crops(bgr, (fw, fh))[0].cpu().numpy().reshape(fh, fw)
        images = torch.from_numpy(_gallery_images(rng, row0, gallery_n)).to(device)
        labels = torch.zeros(gallery_n, dtype=torch.int32, device=device)
        model, aux = train_v2(images, labels, n_components=k, face_shape=face_shape)
        models.append(model)
        artifacts.append(
            (name, to_artifact(model, aux, person_id_map={name: 0}, person_name=name))
        )
        for _ in range(2):
            noisy = np.clip(face + rng.normal(0, 6, face.shape), 0, 255).astype(np.uint8)
            templates.append((name, noisy))
    stack = ModelStack.build(artifacts, device=device)
    bank = TemplateBank(templates, canonical_size=(side, side), device=device)

    lo = np.array([h * 0.2, w * 0.2]).astype(np.int64)
    hi = np.array([h * 0.8, w * 0.8]).astype(np.int64) - side
    pos = rng.integers(lo, hi + 1)
    drift = rng.integers(-step, step + 1, (n_frames, 2))
    plants = np.zeros((n_frames, 2), np.int32)
    for i in range(n_frames):
        plants[i] = pos
        pos = np.clip(pos + drift[i], lo, hi)
    frames = rng.integers(60, 161, (n_frames, h, w, 3), dtype=np.uint8)
    for i, (y, x) in enumerate(plants):
        frames[i, y:y + side, x:x + side] = faces[i % persons][:, :, None]
    return frames, stack, bank, plants, names, models


# The synthetic face of :func:`haar_face` on the cascade's 24 x 24 base grid
# (pixel centres at 0..23): a grey level plus Gaussian blobs
# ``amp * exp(-((y - cy)^2 / 2 sy^2 + (x - cx)^2 / 2 sx^2))``, the paired
# ones mirrored about x = 11.5 at ``11.5 -+ dx``.  Fitted by a random
# hill-climb that counted, through a float64 numpy cascade, the accepted
# windows among 150 renderings at 0.86-1.21 of the base size shifted by up
# to 2 px: 122 of them pass all 25 stages, where a hand-drawn face of the
# same blobs passed 10 and was lost at minNeighbors = 5 in one frame of five.
_HAAR_FACE_LEVEL = 80.9
_HAAR_FACE_BLOBS = (  # (amp, cy, cx, sy, sx)
    (134.2, 11.8, 11.6, 10.0, 7.5),  # head
    (26.6, 11.1, 11.2, 4.5, 0.9),  # nose bridge
    (-62.5, 15.4, 11.3, 1.4, 3.5),  # mouth
)
_HAAR_FACE_PAIRS = (  # (amp, cy, dx, sy, sx)
    (-79.8, 9.4, 2.2, 1.3, 1.8),  # eyes
    (9.7, 4.9, 2.7, 1.5, 2.9),  # brows
    (40.6, 14.4, 7.1, 3.4, 1.7),  # cheeks
)
HAAR_FACE_MARGIN = 0.125  # of the side, rendered around the face on each side
HAAR_TEXTURE_LEVELS = 5.0  # grey levels: the amplitude of each of a person's three waves


def haar_face(side: int, person: int = 0) -> np.ndarray:
    """A synthetic frontal face of nominal ``side`` px that
    ``haarcascade_frontalface_default.xml`` accepts: a uint8 patch of
    ``round(1.25 * side)`` px, the face in its middle and its blobs simply
    continuing into the margin, so that the detector's box (about the
    nominal side, up to 1.05 of it) lies inside the patch.

    ``person`` 0 is the plain recipe; any other adds a smooth texture of a
    few grey levels (three low-frequency waves from
    ``np.random.default_rng(person)``) that tells persons apart and leaves
    the face accepted."""
    patch = int(round(side * (1 + 2 * HAAR_FACE_MARGIN)))
    # Patch pixel centres in base-grid coordinates.
    c = (np.arange(patch) + 0.5 - (patch - side) / 2.0) * (24.0 / side) - 0.5
    yy, xx = np.meshgrid(c, c, indexing="ij")

    def blob(cy, cx, sy, sx):
        return np.exp(-((yy - cy) ** 2 / (2 * sy * sy) + (xx - cx) ** 2 / (2 * sx * sx)))

    img = np.full(yy.shape, _HAAR_FACE_LEVEL)
    for amp, cy, cx, sy, sx in _HAAR_FACE_BLOBS:
        img += amp * blob(cy, cx, sy, sx)
    for amp, cy, dx, sy, sx in _HAAR_FACE_PAIRS:
        img += amp * (blob(cy, 11.5 - dx, sy, sx) + blob(cy, 11.5 + dx, sy, sx))
    if person:
        rng = np.random.default_rng(person)
        for _ in range(3):
            fy, fx = rng.uniform(-0.35, 0.35, 2)
            img += HAAR_TEXTURE_LEVELS * np.cos(fy * yy + fx * xx + rng.uniform(0, 6.28))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)



def haar_plants(n: int, size: Tuple[int, int], rng: np.random.Generator,
                sides: Tuple[int, int] = (60, 220)) -> np.ndarray:
    """``(n, 4)`` int rows ``(y, x, patch, side)``: a face of a nominal side
    drawn from ``sides`` (inclusive) whose :func:`haar_face` patch of
    ``patch`` px has its top-left corner at ``(y, x)``, at least 8 px inside
    the frame."""
    h, w = size
    side = rng.integers(sides[0], sides[1] + 1, n)
    patch = np.rint(side * (1 + 2 * HAAR_FACE_MARGIN)).astype(np.int64)
    y = rng.integers(8, h - patch - 8 + 1)
    x = rng.integers(8, w - patch - 8 + 1)
    return np.stack([y, x, patch, side], axis=1)


def haar_planted_boxes(boxes, plant) -> list:
    """Those of ``boxes`` (x, y, w, h) that name the face of ``plant``
    (a :func:`haar_plants` row): the centre within 0.1 of the side of the
    planted centre, the width within [0.9, 1.25] of the side."""
    y, x, patch, side = (int(v) for v in plant)
    cy, cx = y + patch / 2.0, x + patch / 2.0
    return [
        b for b in boxes
        if abs(b[0] + b[2] / 2.0 - cx) <= 0.1 * side and abs(b[1] + b[3] / 2.0 - cy) <= 0.1 * side
        and 0.9 * side <= b[2] <= 1.25 * side
    ]


def haar_assets(batch: int, size: Tuple[int, int], seed: int, device: torch.device,
                noise: Tuple[float, float] = (110.0, 25.0)):
    """``(frames, plants)`` for the Haar detector: ``(batch, H, W)`` float32
    frames on ``device``, noise ``110 + 25 N(0, 1)`` (not rounded) from a
    ``torch.Generator`` there seeded with ``seed``, each holding one
    :func:`haar_face` at ``plants[i]`` (:func:`haar_plants` from
    ``np.random.default_rng(seed)``)."""
    h, w = size
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frames = torch.empty((batch, h, w), dtype=torch.float32, device=device)
    frames.normal_(noise[0], noise[1], generator=gen)
    plants = haar_plants(batch, size, np.random.default_rng(seed))
    for i, (y, x, patch, side) in enumerate(plants):
        face = torch.from_numpy(haar_face(int(side)).astype(np.float32)).to(device)
        frames[i, y:y + patch, x:x + patch] = face
    return frames, plants


def haar_bgr_frames(n: int, size: Tuple[int, int], seed: int, persons: Sequence[int] = (0,),
                    sides: Tuple[int, int] = (60, 220)):
    """``(frames, plants)`` on the host, as a decoder hands them over:
    ``(n, H, W, 3)`` uint8 BGR frames of grey noise ``110 + 25 N(0, 1)``
    (B = G = R), frame i holding :func:`haar_face` of person
    ``persons[i % len(persons)]`` at ``plants[i]`` (:func:`haar_plants`
    with ``sides``), all from ``np.random.default_rng(seed)``."""
    h, w = size
    rng = np.random.default_rng(seed)
    plants = haar_plants(n, size, rng, sides)
    gray = np.clip(np.rint(rng.normal(110.0, 25.0, (n, h, w)).astype(np.float32)), 0, 255)
    gray = gray.astype(np.uint8)
    for i, (y, x, patch, side) in enumerate(plants):
        gray[i, y:y + patch, x:x + patch] = haar_face(int(side), persons[i % len(persons)])
    return np.repeat(gray[..., None], 3, axis=3), plants


def haar_detect(
    batch: int = 16,
    size: Tuple[int, int] = SIZES["544p"],
    iters: int = 3,
    seed: int = 5,
    depth: int = 6,
    device: Optional[torch.device] = None,
    detector=None,
) -> Dict[str, object]:
    """Full-frame Haar ``detectMultiScale`` throughput (port of
    ``bench_haar``) on :func:`haar_assets`, host grouping included.
    ``device=None`` means the CUDA device.

    ``fps``: :meth:`HaarDetector.detect_multi_scale_batch`, best of
    ``iters`` after one warm-up call.  ``pipelined_fps``: ``depth`` batches
    (the frames plus 1e-3 * i, so no two are equal) with batch i + 1's
    device half issued before batch i's host half.  ``detections`` are the
    last blocking call's boxes, ``handle`` one device half's handle
    (levels, windows per frame, survivors after each compaction) and
    ``raw`` the raw rectangles per frame before grouping."""
    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector

    device = resolve_device(device)
    det = detector or HaarDetector(device=device)
    frames, plants = haar_assets(batch, size, seed, device)
    handle = det.detect_device(frames)  # warm-up: stage tensors, resize matrices
    out = det.detect_finish(handle)
    dt = float("inf")
    for _ in range(iters):
        _synchronize(device)
        t0 = time.perf_counter()
        out = det.detect_multi_scale_batch(frames)
        dt = min(dt, time.perf_counter() - t0)

    _synchronize(device)
    t0 = time.perf_counter()
    handles = [det.detect_device(frames + 1e-3)]
    for i in range(1, depth):
        handles.append(det.detect_device(frames + 1e-3 * (i + 1)))
        det.detect_finish(handles[i - 1])
    det.detect_finish(handles[-1])
    dt_pipe = (time.perf_counter() - t0) / depth
    return {
        "fps": batch / dt,
        "ms_per_batch": dt * 1e3,
        "pipelined_fps": batch / dt_pipe,
        "pipelined_ms_per_batch": dt_pipe * 1e3,
        "size": tuple(size),
        "batch": batch,
        "detected": sum(1 for d in out if d),
        "detections": out,
        "plants": plants,
        "frames": frames,
        "handle": handle,
        "raw": np.bincount(handle["rows"][:, 0].numpy(), minlength=batch).tolist(),
    }


# The CCOEFF configuration: 2 persons x 10 templates (the reference's cap
# per directory) of 100 x 100, one shape group; a survivor names the plant
# within 3 px; best of 3 timed passes.
CCOEFF_PERSONS, CCOEFF_PER_PERSON, CCOEFF_SIDE, CCOEFF_TOL, CCOEFF_ITERS = 2, 10, 100, 3, 3
# The enhanced configuration: 77 training frames per person, the shipped
# lock model's face count.
ENHANCED_PER_PERSON = 77
# The reference's flow trains this person; evaluation adds another's crops.
PIPELINE_PERSON, PIPELINE_STRANGER = 1, 2


def ccoeff_assets(batch: int, size: Tuple[int, int], seed: int):
    """``(frames, templates, plants)`` for the CCOEFF detector, all on the
    host from ``np.random.default_rng(seed)``: :data:`CCOEFF_PER_PERSON`
    templates of each of :data:`CCOEFF_PERSONS` persons (:func:`_person_face`
    of :data:`CCOEFF_SIDE` px plus N(0, 6), person after person), and
    ``(batch, H, W)`` uint8 gray frames of noise ``110 + 25 N(0, 1)``
    (rounded), frame i holding person 0's clean face at ``plants[i]`` =
    (y, x)."""
    h, w = size
    side = CCOEFF_SIDE
    rng = np.random.default_rng(seed)
    faces = [_person_face(p, side) for p in range(CCOEFF_PERSONS)]
    templates = [
        np.clip(face + rng.normal(0, 6, face.shape), 0, 255).astype(np.uint8)
        for face in faces for _ in range(CCOEFF_PER_PERSON)
    ]
    plants = np.stack([rng.integers(0, h - side + 1, batch), rng.integers(0, w - side + 1, batch)],
                      axis=1)
    frames = np.clip(np.rint(rng.normal(110.0, 25.0, (batch, h, w))), 0, 255).astype(np.uint8)
    for i, (y, x) in enumerate(plants):
        frames[i, y:y + side, x:x + side] = faces[0]
    return frames, templates, plants


def ccoeff_planted(boxes, plant) -> list:
    """Those of ``boxes`` (x, y, w, h) at the planted (y, x) within
    :data:`CCOEFF_TOL` px, of the template's size."""
    y, x = (int(v) for v in plant)
    return [b for b in boxes if abs(b[0] - x) <= CCOEFF_TOL and abs(b[1] - y) <= CCOEFF_TOL
            and b[2] == b[3] == CCOEFF_SIDE]


def ccoeff_detect(
    batch: int, size: Tuple[int, int], seed: int, device: Optional[torch.device] = None
) -> Dict[str, object]:
    """CCOEFF detection throughput on :func:`ccoeff_assets`: every frame
    through :meth:`CcoeffTemplateDetector.detect` (one upload and one
    download per frame, host NMS inside), best of :data:`CCOEFF_ITERS`
    passes over the batch after one warm-up pass.  ``device=None`` means
    the CUDA device."""
    from face_detection_recognization_pca_tpu_torch.detect.ccoeff import CcoeffTemplateDetector

    device = resolve_device(device)
    frames, templates, plants = ccoeff_assets(batch, size, seed)
    det = CcoeffTemplateDetector(templates, device=device)
    out = [det.detect(f) for f in frames]  # warm-up: template spectra, FFT plans
    dt = float("inf")
    for _ in range(CCOEFF_ITERS):
        _synchronize(device)
        t0 = time.perf_counter()
        out = [det.detect(f) for f in frames]
        dt = min(dt, time.perf_counter() - t0)
    return {
        "fps": batch / dt,
        "ms_per_frame": dt / batch * 1e3,
        "size": tuple(size),
        "batch": batch,
        "templates": templates,
        "detections": out,
        "plants": plants,
        "frames": frames,
        "detector": det,
    }


def enhanced_assets(n_scan: int, size: Tuple[int, int], seed: int):
    """``(train, scan_frames, scan_plants, person_id_map, fresh_frames,
    profile_crops)`` for the enhanced ensemble, uint8 BGR frames of
    ``size`` on the host: ``train`` holds for persons 1 and 2 (``person1``,
    ``person2``, ids 0 and 1) ``(frames, plants)`` of
    :func:`haar_bgr_frames` with :data:`ENHANCED_PER_PERSON` frames of that
    person's face at a seeded side of 120-220 px (seed ``seed + 1 + id``),
    whose detected crops train the model.  The scan's ``n_scan`` frames are
    training frames of the persons in turn, drawn from
    ``np.random.default_rng(seed)``: as the reference scans the video its
    model was trained on.  What the model has not seen: 8
    ``fresh_frames`` of the persons in turn (seed ``seed + 3``; the
    ensemble's similarity, ``0.7 cos + 0.3 / (1 + L2)``, puts such a crop
    near 0.62-0.77 against the 0.6 threshold), and as ``profile_crops`` the
    whole uint8 gray :func:`haar_face` patches of the first 4 of them,
    which the profile cascade takes for right profiles."""
    persons = (1, 2)
    train = [haar_bgr_frames(ENHANCED_PER_PERSON, size, seed + 1 + i, persons=(p,),
                             sides=(120, 220))
             for i, p in enumerate(persons)]
    rng = np.random.default_rng(seed)
    pick = [(i % len(persons), int(rng.integers(ENHANCED_PER_PERSON))) for i in range(n_scan)]
    scan = np.stack([train[p][0][j] for p, j in pick])
    plants = np.stack([train[p][1][j] for p, j in pick])
    fresh, fresh_plants = haar_bgr_frames(8, size, seed + 3, persons=persons, sides=(120, 220))
    profiles = [haar_face(int(side), persons[i % len(persons)])
                for i, side in enumerate(fresh_plants[:4, 3])]
    return train, scan, plants, {f"person{p}": i for i, p in enumerate(persons)}, fresh, profiles


def pipeline_assets(n_frames: int, size: Tuple[int, int], seed: int):
    """``(frames, plants, eval_crops, eval_ids)`` for the reference's flow on
    :data:`PIPELINE_PERSON`: :func:`haar_bgr_frames` of that person (seed
    ``seed``) to detect, train and scan; to evaluate, 16 BGR crops of the
    planted face's nominal square cut from as many fresh frames of the
    person (seed ``seed + 1``, id 0), then 16 of
    :data:`PIPELINE_STRANGER` (seed ``seed + 2``, id -1: a reject is
    right)."""
    frames, plants = haar_bgr_frames(n_frames, size, seed, persons=(PIPELINE_PERSON,))
    crops, ids = [], []
    for j, (person, pid) in enumerate(((PIPELINE_PERSON, 0), (PIPELINE_STRANGER, -1))):
        fresh, fresh_plants = haar_bgr_frames(16, size, seed + 1 + j, persons=(person,))
        for frame, (y, x, patch, side) in zip(fresh, fresh_plants):
            m = (patch - side) // 2
            crops.append(np.ascontiguousarray(frame[y + m:y + m + side, x + m:x + m + side]))
        ids += [pid] * 16
    return frames, plants, crops, ids


def _e2e(
    open_frames: Callable[[], Iterable[np.ndarray]],
    batch: int,
    max_frames: int,
    resize_to: Optional[str],
    variants: Sequence[str],
    label_prefix: str,
    annotate: Optional[Callable],
    write: Optional[Callable[[str, np.ndarray], None]],
    left_out: Sequence[str],
    source: Dict[str, object],
    device: torch.device,
) -> Dict[str, object]:
    """The body of :func:`e2e_frames` and :func:`e2e_video`: ``open_frames()``
    starts a new pass over the uint8 BGR frames (a decode, for a video),
    ``source`` holds the ``_video`` and ``_native_ring`` entries."""
    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
    from face_detection_recognization_pca_tpu_torch.detect.template import (
        TemplateBank,
        TemplateDetector,
    )
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import recognize
    from face_detection_recognization_pca_tpu_torch.ops.color import bgr_to_gray_exact
    from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear_u8_exact

    rs_wh = None  # (w, h) of resize_to
    if resize_to is not None:
        rh, rw = SIZES[resize_to]
        rs_wh = (rw, rh)

    def resize64(crop: np.ndarray) -> np.ndarray:
        src = torch.from_numpy(np.ascontiguousarray(crop))
        return resize_bilinear_u8_exact(src, (64, 64)).numpy().astype(np.float32)

    def grays_of(bgrs: np.ndarray) -> torch.Tensor:
        return bgr_to_gray_exact(torch.from_numpy(bgrs).to(device))

    # Train stage (the reference's detect -> train): Haar on the first 3
    # batches in gray, the largest box of each frame cropped (the crop's end
    # from the unclamped corner, as the JAX function cuts it), resized to
    # 64 x 64, z-score + PCA.  Timed separately.
    haar = HaarDetector(device=device)
    t_train0 = time.perf_counter()
    train_bgrs = []
    frames = iter(open_frames())
    try:
        for f in frames:
            if len(train_bgrs) >= 3 * batch:
                break
            train_bgrs.append(f)
    finally:
        getattr(frames, "close", lambda: None)()
    train_grays = []
    if train_bgrs:
        gray = grays_of(np.stack(train_bgrs))
        if rs_wh:
            gray = resize_bilinear_u8_exact(gray, rs_wh)
        train_grays = list(gray.cpu().numpy())
    train_crops, train_tpls = [], []
    for i in range(0, len(train_grays), batch):
        stack = np.stack(train_grays[i:i + batch]).astype(np.float32)
        if stack.shape[0] < batch:
            stack = np.concatenate(
                [stack, np.zeros((batch - stack.shape[0],) + stack.shape[1:], np.float32)])
        dets_pb = haar.detect_multi_scale_batch(stack)
        for j, dets in enumerate(dets_pb[:len(train_grays[i:i + batch])]):
            if not dets:
                continue
            x, y, bw, bh = max(dets, key=lambda d: d[2] * d[3])
            crop = train_grays[i + j][max(y, 0):y + bh, max(x, 0):x + bw]
            if crop.size:
                train_crops.append(resize64(crop))
                if len(train_tpls) < 8:
                    train_tpls.append(crop)
    if len(train_crops) < 4:
        return {f"{label_prefix}_skipped": f"only {len(train_crops)} training crops"}
    n = len(train_crops)
    flat = torch.from_numpy(np.stack(train_crops).reshape(n, -1)).to(device)
    with exact_float32():
        model, _ = train_v2(flat, torch.zeros(n, dtype=torch.int32, device=device),
                            n_components=min(50, n - 1))
    _synchronize(device)
    train_wall = time.perf_counter() - t_train0
    names = {0: "person0"}

    def run_variant(detect_device, detect_finish, label: str) -> Dict[str, object]:
        t0 = time.perf_counter()
        n_frames = n_recognized = n_detected = 0
        pending = None  # (handle, bgr frames, gray frames on the host)

        def finish(pend):
            nonlocal n_frames, n_recognized, n_detected
            handle, bgrs, grays = pend
            dets_pb = detect_finish(handle)
            n_detected += sum(1 for d in dets_pb[:len(bgrs)] if d)
            crops = np.zeros((batch, 64, 64), np.float32)
            picks = []
            for i, dets in enumerate(dets_pb[:len(bgrs)]):
                if not dets:
                    continue
                x, y, bw, bh = max(dets, key=lambda d: d[2] * d[3])
                x, y = max(x, 0), max(y, 0)
                crop = grays[i][y:y + bh, x:x + bw]
                if crop.size == 0:
                    continue
                crops[len(picks)] = resize64(crop)
                picks.append((i, (x, y, bw, bh)))
            if picks:
                with exact_float32():
                    ids, confs = recognize(model, torch.from_numpy(crops).to(device), 0.7)
                ids, confs = ids.cpu().numpy(), confs.cpu().numpy()
                for j, (i, box) in enumerate(picks):
                    name = names.get(int(ids[j]), "unknown") if ids[j] >= 0 else "unknown"
                    if name != "unknown":
                        n_recognized += 1
                    if annotate is not None:
                        annotate(bgrs[i], box, name, float(confs[j]))
            if write is not None:
                for f in bgrs:
                    write(label, f)
            n_frames += len(bgrs)

        def issue(bgrs):
            # The batch padded to ``batch`` frames, gray on the device; the
            # host takes its gray frames for the crops before the detector
            # is queued, so that copy waits for the gray alone.
            stack = np.zeros((batch,) + bgrs[0].shape, np.uint8)
            stack[:len(bgrs)] = np.stack(bgrs)
            gray = grays_of(stack)
            grays = list(gray[:len(bgrs)].cpu().numpy())
            return detect_device(gray), grays

        bgrs = []
        frames = iter(open_frames())
        try:
            for frame in frames:
                if n_frames + len(bgrs) >= max_frames:
                    break
                if rs_wh:
                    chw = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1)))
                    frame = np.ascontiguousarray(
                        resize_bilinear_u8_exact(chw, rs_wh).numpy().transpose(1, 2, 0))
                bgrs.append(frame)
                if len(bgrs) == batch:
                    handle, grays = issue(bgrs)
                    if pending is not None:
                        finish(pending)
                    pending = (handle, bgrs, grays)
                    bgrs = []
        finally:
            getattr(frames, "close", lambda: None)()
        if bgrs:  # the last, partial batch
            handle, grays = issue(bgrs)
            if pending is not None:
                finish(pending)
            pending = (handle, bgrs, grays)
        if pending is not None:
            finish(pending)
        dt = time.perf_counter() - t0
        p = f"{label_prefix}_{label}"
        return {
            f"{p}_fps": n_frames / dt,
            f"{p}_frames": n_frames,
            f"{p}_detected": n_detected,
            f"{p}_recognized": n_recognized,
            # The reference scanner's exit summary: the share of frames with
            # a recognized face.
            f"{p}_recognition_rate": round(n_recognized / max(n_frames, 1), 3),
            f"{p}_output": None,
        }

    out: Dict[str, object] = {
        f"{label_prefix}_{key}": value for key, value in source.items()}
    out[f"{label_prefix}_train_wall_s"] = train_wall
    out[f"{label_prefix}_train_crops"] = n
    if left_out:
        out[f"{label_prefix}_left_out"] = list(left_out)
    if "haar" in variants:
        out.update(run_variant(haar.detect_device, haar.detect_finish, "haar"))
    if "ncc" not in variants:
        return out

    # The NCC variant: the video's own training crops as 128 x 128
    # templates, padded to 8 as the JAX function pads them.
    while len(train_tpls) < 8:
        train_tpls.append(train_tpls[len(train_tpls) % max(len(train_tpls), 1)])
    bank = TemplateBank([("person0", t.astype(np.uint8)) for t in train_tpls[:8]],
                        canonical_size=(128, 128), device=device)
    det = TemplateDetector(bank)

    def ncc_finish(handle):
        scale_meta, packed = handle
        return [[(d.x, d.y, d.width, d.height) for d in per_frame]
                for per_frame in det.detect_fused_finish(scale_meta, packed, batch)]

    out.update(run_variant(det.detect_fused_device, ncc_finish, "ncc"))
    return out


def e2e_frames(
    bgr_frames: Sequence[np.ndarray],
    batch: int = 16,
    max_frames: int = 160,
    resize_to: Optional[str] = None,
    variants: Sequence[str] = ("haar", "ncc"),
    label_prefix: str = "e2e",
    annotate: Optional[Callable] = None,
    write: Optional[Callable[[str, np.ndarray], None]] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, object]:
    """The end-to-end video loop of ``bench_e2e_video`` on uint8 BGR frames
    held in memory, with no decoder and no OpenCV: train on the frames' own
    Haar detections, then per variant (Haar, then the fused NCC template
    detector) the device half of batch N + 1 issued before the host half
    of batch N, the largest box of each frame cropped, resized to 64 x 64
    and recognized at threshold 0.7.  Gray is
    :func:`..ops.color.bgr_to_gray_exact` on the device and every resize
    :func:`..ops.resize.resize_bilinear_u8_exact`, both ``cv2``'s bytes.

    ``annotate(frame, box, name, confidence)`` draws on a frame and
    ``write(variant, frame)`` takes it after its batch; ``None`` leaves that
    stage out.  The stages left out are listed under ``{prefix}_left_out``
    (decode always).  ``device=None`` means the CUDA device.  Fewer than
    4 training crops return ``{prefix}_skipped``."""
    left_out = ["decode"] + (["annotate"] if annotate is None else []) + (
        ["encode"] if write is None else [])

    def open_frames():
        # Each pass gets frames of its own, as a decoder hands them over, so
        # one variant's drawing never reaches the next.
        return iter(bgr_frames) if annotate is None else (f.copy() for f in bgr_frames)

    return _e2e(open_frames, batch, max_frames, resize_to, variants, label_prefix,
                annotate, write, left_out,
                {"video": f"{len(bgr_frames)} frames in memory", "native_ring": False},
                resolve_device(device))


def e2e_video(
    video: str,
    batch: int = 16,
    max_frames: int = 160,
    resize_to: Optional[str] = None,
    variants: Sequence[str] = ("haar", "ncc"),
    label_prefix: str = "e2e",
    device: Optional[torch.device] = None,
) -> Dict[str, object]:
    """End-to-end video throughput (port of ``bench_e2e_video``): ``video``
    decoded (by ``io.native.NativeVideoReader`` where its library is built,
    else ``io.video.VideoReader``) once for training and once per variant,
    through :func:`e2e_frames`' loop, each frame annotated with
    ``utils.annotate.draw_guided`` and encoded by ``io.video.VideoWriter``
    into ``fdrp_{prefix}_{variant}.mp4`` in the temporary directory
    (``{prefix}_{variant}_output``).  Decode and encode are inside each
    variant's clock.  ``resize_to`` (a :data:`SIZES` key) resizes every
    frame on read.  A missing file returns ``{prefix}_skipped``."""
    import importlib.util
    import os
    import tempfile

    from face_detection_recognization_pca_tpu_torch.io import native

    if not os.path.exists(video):
        return {f"{label_prefix}_skipped": f"{video} not found"}
    ring = native.available()
    has_cv2 = importlib.util.find_spec("cv2") is not None

    def open_reader():
        if ring:
            return native.NativeVideoReader(video, ring=6)
        from face_detection_recognization_pca_tpu_torch.io.video import VideoReader

        return VideoReader(video)

    def open_frames():
        reader = open_reader()
        try:
            yield from reader.frames()
        finally:
            reader.close()

    reader = open_reader()
    fps = reader.fps if ring else reader.meta.fps
    reader.close()
    paths = {}
    writers = {}

    def write(label: str, frame: np.ndarray) -> None:
        from face_detection_recognization_pca_tpu_torch.io.video import VideoWriter

        if label not in writers:
            paths[label] = os.path.join(tempfile.gettempdir(), f"fdrp_{label_prefix}_{label}.mp4")
            writers[label] = VideoWriter(paths[label], (frame.shape[1], frame.shape[0]), fps)
        writers[label].write(frame)

    annotate = None
    if has_cv2:
        from face_detection_recognization_pca_tpu_torch.utils.annotate import draw_guided

        annotate = draw_guided
    try:
        out = _e2e(open_frames, batch, max_frames, resize_to, variants, label_prefix, annotate,
                   write if has_cv2 else None, [] if has_cv2 else ["annotate", "encode"],
                   {"video": os.path.basename(video), "native_ring": ring},
                   resolve_device(device))
    finally:
        for w in writers.values():
            w.close()
    for label, path in paths.items():
        out[f"{label_prefix}_{label}_output"] = path
    return out
