#!/usr/bin/env python3
"""Where the full-frame template detector's time goes on one CUDA GPU.

    python3 scripts_torch/detect_profile.py [--size 1080p] [--batch 16]

Builds ``bench.full_frame_assets`` (8 templates of 128 x 128, scales
0.8 / 1.0 / 1.2, seed 3) and prints, for ``TemplateDetector``:

* the device ms per 16-frame batch by kernel family and the ten longest
  kernels (``torch.profiler`` over 3 device halves), and the resize and
  the banded window sums each alone (CUDA events; they share the GEMM
  kernels);
* the host clock per batch of the device half, 5 queued back to back, in
  the order kept, uploaded, uploaded, kept: ``kept`` leaves the resize's
  interpolation matrices on the card between calls (``ops/resize.py``
  caches them), ``uploaded`` clears that cache before every call, which
  is what every call paid before the cache;
* the same for the end-to-end call (device half, download, host
  selection), and the host selection alone.

Every line names the card and its power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from face_detection_recognization_pca_tpu_torch import bench, device as port_device  # noqa: E402
from face_detection_recognization_pca_tpu_torch.detect import template  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import resize  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="1080p", choices=sorted(bench.SIZES))
    parser.add_argument("--batch", type=int, default=16)
    args = parser.parse_args()
    dev = port_device.require_cuda()
    port_device.disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    frames, bank, _ = bench.full_frame_assets(args.batch, bench.SIZES[args.size], 8, 3, dev)
    det = template.TemplateDetector(bank)
    meta, packed = det.detect_fused_device(frames)
    assert all(len(d) == 1 for d in det.detect_fused_finish(meta, packed, args.batch))

    rows = bench.traced_kernels(lambda: det.detect_fused_device(frames), 3)
    print(f"[detect-profile] {args.size} batch {args.batch}: device ms per batch by family "
          f"{json.dumps(bench.kernel_families(rows))}, {sum(c for _, _, c in rows):.0f} kernels, "
          f"sum {sum(us for _, us, _ in rows) / 1e3:.3f} ms; longest "
          f"{[(n[:70], round(us / 1e3, 3)) for n, us, _ in rows[:10]]}; card {card}")

    def resize_all():
        with port_device.exact_float32():
            return [resize.resize_bilinear(frames, (m.rw, m.rh)) for m in meta]

    resized = resize_all()
    th, tw = bank.canonical_size

    def banded_all():
        with port_device.exact_float32():
            for f in resized:
                by = template._band(f.shape[1], f.shape[1] - th + 1, th, dev)
                bx = template._band(f.shape[2], f.shape[2] - tw + 1, tw, dev)
                by.T @ f @ bx
                by.T @ (f * f) @ bx

    print(f"[detect-profile] CUDA-event ms per batch: resize {bench.cuda_time_ms(resize_all, 5, 2)}, "
          f"banded window sums {bench.cuda_time_ms(banded_all, 5, 2)}; card {card}")
    del resized
    torch.cuda.empty_cache()

    def clock(fn, uploaded: bool, calls: int = 5) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            if uploaded:
                resize._MATRIX_CACHE.clear()
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    order = (False, True, True, False)
    for name, fn in (("device half", lambda: det.detect_fused_device(frames)),
                     ("end to end", lambda: det.detect_fused_batch(frames))):
        ms = [clock(fn, uploaded) for uploaded in order]
        print(f"[detect-profile] {name}, host-clock ms per batch (kept, uploaded, uploaded, "
              f"kept): {ms}; card {card}")
    packed_host = packed.cpu()
    t0 = time.perf_counter()
    for _ in range(20):
        det.detect_fused_finish(meta, packed_host, args.batch)
    print(f"[detect-profile] host selection alone {(time.perf_counter() - t0) / 20 * 1e3} ms per "
          f"batch; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
