#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. environment: torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``), both TF32 switches turned off and checked;
2. build: ``csrc/fused_match.cu`` compiled with nvcc for sm_90a;
3. kernel against plain: ``fused_match`` against ``recognize_linearized``
   on the card at the tracker's shapes, a ragged masked case, an exact
   tie and a zero-norm crop (ids equal, conf within 1e-5), and both
   timed with CUDA events;
4. the slice: ``tracker_assets`` at 1080p with 64 streams and 8 frame
   batches (seed 4), a snapshot-PCA model trained on the card, then 8
   ``process_batch`` steps and one 8-frame ``process_window``; every
   position and gallery row must be the planted one, and the kernel's
   launch count must show that both paths went through it.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits nonzero without that line, as it does when PyTorch
sees no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch import bench, device as port_device
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
from face_detection_recognization_pca_tpu_torch.ops import _build
from face_detection_recognization_pca_tpu_torch.ops.fused_match import (
    LinearizedModel,
    fused_match,
    recognize_linearized,
)
from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
    MultiStreamRecognizer,
)

CONF_ATOL = 1e-5  # float32 sums in another order than cuBLAS's; cosines ~1
STREAMS, BATCHES, SEED = 64, 8, 4
KERNEL = {
    "name": "fused_match",
    "route": "cuda",
    "source": "face_detection_recognization_pca_tpu_torch/csrc/fused_match.cu",
    "replaces": "face_detection_recognization_pca_tpu/ops/pallas_kernels.py:122",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load("fused_match")
    seconds = time.perf_counter() - t0
    log = _build.library_path("fused_match").with_suffix(".log").read_text()
    ptxas = " | ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line
    )
    print(f"[build] fused_match.cu in {seconds:.2f} s; ptxas: {ptxas}")


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


def _time_ms(fn, iters=200) -> float:
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_vs_plain(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = {
        "slice": _match_case(dev, gen, 64, 96 * 96, 64, 256, near=list(range(0, 256, 4))),
        "ragged_masked": _match_case(dev, gen, 5, 4099, 8, 33, near=[0, 31, 32, 5, 10],
                                     masked=3),
        "tie": _match_case(dev, gen, 4, 576, 16, 40, near=[3, 3, 9, 20], tie=(3, 7)),
        "zero_norm": _match_case(dev, gen, 3, 576, 16, 40, near=[1, 2, 3], zero_row=1),
    }
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
        print(f"[kernel] {name}: ids {ids_k.tolist()[:8]} max|dconf| {err:.3g}")
        check(torch.equal(ids_k, ids_p), f"{name}: ids {ids_k.tolist()} vs {ids_p.tolist()}")
        check(err <= CONF_ATOL, f"{name}: conf error {err} > {CONF_ATOL}")
    check(int(fused_match(*cases["tie"])[0][0]) == 3, "tie goes to the first column")
    zero_ids, zero_conf = fused_match(*cases["zero_norm"])
    check(int(zero_ids[1]) == 0 and float(zero_conf[1]) == 0.0, "zero-norm crop scores 0")
    masked_ids = fused_match(*cases["ragged_masked"])[0]
    check(bool((masked_ids < 30).all()), "masked rows never win")

    crops, m, bias, gallery_t, gnorm, _ = cases["slice"]
    lin = LinearizedModel(m, bias, gallery_t, gnorm,
                          torch.zeros(gallery_t.shape[1], dtype=torch.int32, device=dev),
                          (96, 96))

    def plain():
        return recognize_linearized(lin, crops)

    def kernel():
        return fused_match(crops, m, bias, gallery_t, gnorm)

    # Alternate plain, kernel, kernel, plain inside one call on one card.
    p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
    timing = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    print(f"[kernel] slice shape B=64 D=9216 k=64 N=256: kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.4f}/{p2:.4f} ms")
    return {"max_abs_err": max_err, **timing}


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

    fused_match.launches = 0
    outs, state_b = run_batches()
    wout, state_w = run_window()
    launches = fused_match.launches

    check(launches == 2 * BATCHES, f"fused_match launched {launches} times, want {2 * BATCHES}")
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


def main() -> int:
    dev = phase_environment()
    card = torch.cuda.get_device_name(0)
    phase_build()
    kernel = phase_kernel_vs_plain(dev)
    launches = phase_slice(dev, card)
    print(json.dumps({"kernels": [{**KERNEL, "launches": launches, **kernel}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
