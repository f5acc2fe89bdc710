"""Self-checking workloads (ports of the JAX package's ``bench.py``).

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
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.ops.gallery_match import (
    _gallery_match_plain,
    gallery_match,
)

SIZES = {"1080p": (1080, 1920), "720p": (720, 1280), "544p": (544, 960)}
WIN = 192  # search window side (guided scanner: 1.5-2x face box)
TPL = 96  # template / face box side
GALLERY_N = 256
N_COMPONENTS = 64


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
    yy, xx = np.mgrid[0:TPL, 0:TPL].astype(np.float32) / TPL
    face = (
        140
        + 60 * np.sin(6.28 * yy * 2.1)
        + 40 * np.cos(6.28 * xx * 1.7)
        + rng.normal(0, 8, (TPL, TPL))
    ).astype(np.float32)

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

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frames = torch.empty((batches * streams, h, w), dtype=torch.float32, device=device)
    frames.normal_(110.0, 25.0, generator=gen)
    flat_plants = torch.from_numpy(plants.reshape(-1, 2)).to(device)
    ar = torch.arange(TPL, device=device)
    rows = (flat_plants[:, 0, None] + ar)[:, :, None]
    cols = (flat_plants[:, 1, None] + ar)[:, None, :]
    index = torch.arange(batches * streams, device=device)[:, None, None]
    frames[index, rows, cols] = torch.from_numpy(face).to(device)
    frames = frames.reshape(batches, streams, h, w)

    gal_imgs = np.stack(
        [
            np.roll(face, (rng.integers(-2, 3), rng.integers(-2, 3)), (0, 1)).reshape(-1)
            + rng.normal(0, 4, TPL * TPL)
            for _ in range(GALLERY_N)
        ]
    ).astype(np.float32)
    gal_imgs[0] = face.reshape(-1)
    return frames, torch.from_numpy(gal_imgs).to(device), face, plants


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


def profiler_ms(fn: Callable[[], object], calls: int = 50) -> Union[float, None]:
    """Kernel time per call of ``fn`` summed by ``torch.profiler`` over
    ``calls`` eager calls, or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for _, us, _ in device_kernels(prof))
    return total_us / calls / 1e3 if total_us > 0 else None


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
