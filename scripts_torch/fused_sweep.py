#!/usr/bin/env python3
"""Timing, sweep and profile of the fused-match kernel on one CUDA GPU.

    python3 scripts_torch/fused_sweep.py [--variants] [--phases] [--profile]

With no option it times ``fused_match`` at the six shapes of the main
paths (``chip_smoke.FUSED_SHAPES``: B 32, 64, 256 and 512 at D 9216, B 64
and B 768 at D 16384; k 64, N 256, the data of ``chip_smoke.py``'s
``_match_case``)
beside its plain version and ``crops @ m``, taken in the order plain,
kernel, library, library, kernel, plain, device-only (CUDA events around
replays of a CUDA graph of 20 calls), with the bound and the kernel's
share of it.

``--variants`` times the kernel device-only at each shape under other
launch plans (``PLANS``: the wrapper's ``_MAX_SPLITS``, ``_SMALL_B`` and ``_FINISH_ROWS``;
no rebuild), and copies of ``csrc/fused_match.cu`` without parts of the
work (``VARIANTS``, one nvcc per copy, all started together, into
``build/sweep_fused/``; their answers are wrong and only their times mean
anything), the copies taken in order and then in reverse order.  It also
times a CUDA graph of one-element ``add_`` calls: what one more kernel
launch costs the card inside a graph.

``--phases`` builds a copy of ``csrc/fused_match.cu`` whose thread 0 of
each block reads ``clock64()`` and ``%globaltimer`` at each ``// ---- phase:``
mark, runs it once at each shape, and prints for each of the two kernels
(the products and the finish) the median and the largest SM cycles of each
phase over its blocks, and its timeline in ns from the products' first
block's start: first and last block start, last end, and for the finish
the end of its last wait for the products.  A phase that ends at a barrier
includes the wait for the slowest thread.

``--profile`` traces the tracker slice (1080p, 64 streams, 8 frame
batches, seed 4) with ``torch.profiler``: device time per frame step by
kernel, against the host-clock step time.

Every result line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    BATCHES,
    FUSED_SHAPES as SHAPES,
    SEED,
    STREAMS,
    _match_case,
    fused_bound,
)
from face_detection_recognization_pca_tpu_torch import bench  # noqa: E402
from face_detection_recognization_pca_tpu_torch import device as port_device  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import _build  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm  # noqa: E402

# name -> the wrapper's plan constants.
PLANS = {
    "as built": {},
    "splits <= 16": {"_MAX_SPLITS": 16},
    "splits <= 32": {"_MAX_SPLITS": 32},
    "splits <= 48": {"_MAX_SPLITS": 48},
    "splits <= 96": {"_MAX_SPLITS": 96},
    "splits <= 132": {"_MAX_SPLITS": 132},
    "128-crop tiles only": {"_SMALL_B": 0},
    "64-crop tiles only": {"_SMALL_B": 1 << 30},
    "4 crops per finishing block": {"_FINISH_ROWS": (4, 4)},
    "8 crops per finishing block": {"_FINISH_ROWS": (8, 8)},
}
# name -> edits of csrc/fused_match.cu as (pattern, replacement).
VARIANTS = {
    "as built": [],
    "finish returns at once": [(r'(griddepcontrol\.wait;\\n" ::: "memory"\);[^\n]*\n)',
                                r"\1  return;\n")],
    "without the scores": [(r"for \(int n0 = 0; n0 < N; n0 \+= kGCols\)",
                            "for (int n0 = 0; n0 < 0; n0 += kGCols)")],
    "scores without their products": [(r"if \(8 \* warp < K - c \* kTileK\) \{",
                                       "if (false) {")],
    "scores without their epilogue": [(r"if \(colg < N\) \{", "if (false) {")],
    "without the dependent launch": [(r"config\.numAttrs = 1;", "config.numAttrs = 0;")],
}
PHASE_MARK = re.compile(r"  // ---- phase: ([a-z ]+) ----\n")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def shape_case(dev, b: int, d: int):
    """(crops, m, bias, gallery_t, gnorm, m_split) at (B, D), k 64, N 256,
    crops near gallery rows i % 256."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    crops, m, bias, gallery_t, gnorm, _ = _match_case(dev, gen, b, d, 64, 256,
                                                      near=[i % 256 for i in range(b)])
    return crops, m, bias, gallery_t, gnorm, tfm.split_m(m)


def kernel_call(case):
    crops, m, bias, gallery_t, gnorm, m_split = case
    return lambda: tfm.fused_match(crops, m, bias, gallery_t, gnorm, m_split=m_split)


def time_shapes(dev, smi: str) -> None:
    for name, (b, d) in SHAPES.items():
        case = shape_case(dev, b, d)
        crops, m, bias, gallery_t, gnorm, _ = case
        lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm,
                                  torch.zeros(256, dtype=torch.int32, device=dev), (1, d))
        turns = bench.time_in_turns(
            {"plain": lambda: tfm.recognize_linearized(lin, crops), "kernel": kernel_call(case),
             "library": lambda: crops @ m},
            ("plain", "kernel", "library", "library", "kernel", "plain"), loop_iters=50,
            graph_calls=20)
        dev_us = {k: [round(x * 1e3, 3) for x in v] for k, v in turns["device"].items()}
        bnd = fused_bound(b, d, 64, 256)
        share = bnd["bound_ms"] * 1e3 / (sum(dev_us["kernel"]) / len(dev_us["kernel"]))
        print(f"[time] {name}: {json.dumps(tfm._grid(b, d, 64, tfm._sm_count(0))._asdict())}; "
              f"device-only us per call {json.dumps(dev_us)}; bound {bnd['bound_ms'] * 1e3:.3f} "
              f"us ({bnd['bound_by']}), share {share:.3f}; card {smi}")


def build_copy(name: str, src: str) -> ctypes.CDLL:
    """The library built from ``src`` as build/sweep_fused/<name>.cu."""
    slug = re.sub(r"\W+", "_", name).strip("_")
    out = REPO / "build" / "sweep_fused"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{slug}.cu").write_text(src)
    proc = _build.nvcc(out / f"{slug}.cu", out / f"lib{slug}.so")
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return tfm._declare(ctypes.CDLL(str(out / f"lib{slug}.so")))


def build_variant(name: str) -> ctypes.CDLL:
    src = (_build.CSRC / "fused_match.cu").read_text()
    for pattern, repl in VARIANTS[name]:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
    return build_copy(name, src)


def using(lib=None, **constants):
    """Set the wrapper's library and constants; returns the restore."""
    keys = ("_lib", "_MAX_SPLITS", "_SMALL_B", "_FINISH_ROWS")
    saved = {key: getattr(tfm, key) for key in keys}
    if lib is not None:
        tfm._lib = lambda: lib
    for key, value in constants.items():
        setattr(tfm, key, value)
    tfm._WORKSPACE.clear()  # fresh scratch of the plan's shape

    def restore():
        for key, value in saved.items():
            setattr(tfm, key, value)
        tfm._WORKSPACE.clear()

    return restore


def sweep(dev, smi: str) -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    print(f"[sweep] {len(built)} variants built in {time.perf_counter() - t0:.1f} s")
    for shape, (b, d) in SHAPES.items():
        case = shape_case(dev, b, d)
        want = tfm._match_plain(*case[:5], None)
        times = {}
        for name, consts in list(PLANS.items()) + list(reversed(PLANS.items())):
            restore = using(**consts)
            try:
                ids, conf = kernel_call(case)()
                torch.cuda.synchronize()
                if not torch.equal(ids, want[0]) or float((conf - want[1]).abs().max()) > 1e-5:
                    raise RuntimeError(f"{name} at {shape}: the kernel disagrees with plain")
                ms = bench.cuda_graph_ms(kernel_call(case), 20)
                plan = tfm._grid(b, d, 64, tfm._sm_count(0))
            finally:
                restore()
            times.setdefault(f"{name} {tuple(plan)}", []).append(round(ms * 1e3, 3))
        for name in list(VARIANTS) + list(reversed(VARIANTS)):
            restore = using(built[name])
            try:
                ms = bench.cuda_graph_ms(kernel_call(case), 20)
            finally:
                restore()
            times.setdefault(f"source {name}", []).append(round(ms * 1e3, 3))
        print(f"[sweep] {shape}: device-only us per call (in order, in reverse; plan = splits, "
              f"k chunks, tiles, tile_b, chunks per split) {json.dumps(times)}; card {smi}")
    one = torch.zeros(1, device=dev)
    floor = [bench.cuda_graph_ms(lambda: one.add_(1.0)) for _ in range(2)]
    print(f"[sweep] one more kernel in a CUDA graph (one-element add_): device-only us "
          f"{[round(x * 1e3, 3) for x in floor]}; card {smi}")


def phases(dev, smi: str) -> None:
    src = (_build.CSRC / "fused_match.cu").read_text()
    finish_at = src.index("fused_match_finish(")  # the second kernel's definition
    marks = [(m.start(), m[1]) for m in PHASE_MARK.finditer(src)]
    kernels = {"products": [n for at, n in marks if at < finish_at],
               "finish": [n for at, n in marks if at > finish_at]}
    if any(not names or names[-1] != "end" for names in kernels.values()):
        raise RuntimeError(f"phase marks {kernels}: each kernel's last must be 'end'")
    src = src.replace('#include "mma_sync.cuh"\n', '#include "mma_sync.cuh"\n'
                      '__device__ long long phase_clock[2][1024][16];\n'
                      '__device__ long long phase_ns[2][1024][16];\n', 1)
    bid = "blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)"
    mark = ("  if (threadIdx.x == 0) {{ long long ns_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
            ": \"=l\"(ns_)); phase_clock[{k}][" + bid + "][{i}] = clock64(); phase_ns[{k}][" + bid +
            "][{i}] = ns_; }}\n")
    # A mark at each phase mark; phase i of a kernel runs from its mark i to
    # its mark i + 1.
    at = 0
    for k, names in enumerate(kernels.values()):
        for i, name in enumerate(names):
            anchor = f"  // ---- phase: {name} ----\n"
            at = src.index(anchor, at)
            src = src[:at] + mark.format(k=k, i=i) + anchor.replace("phase:", "mark:") + \
                src[at + len(anchor):]
    src = src.replace('extern "C" {', """extern "C" {
int phase_read(long long* c, long long* t) {
  if (cudaMemcpyFromSymbol(c, phase_clock, sizeof(phase_clock))) return 1;
  return (int)cudaMemcpyFromSymbol(t, phase_ns, sizeof(phase_ns));
}
int phase_reset() {
  void* p;
  cudaGetSymbolAddress(&p, phase_clock);
  if (cudaMemset(p, 0, sizeof(phase_clock))) return 1;
  cudaGetSymbolAddress(&p, phase_ns);
  return (int)cudaMemset(p, 0, sizeof(phase_ns));
}
""", 1)
    lib = build_copy("phases", src)
    lib.phase_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for shape, (b, d) in SHAPES.items():
        case = shape_case(dev, b, d)
        restore = using(lib)
        try:
            for _ in range(3):  # warm up, then one call on cleared clocks
                kernel_call(case)()
            torch.cuda.synchronize()
            if lib.phase_reset() != 0:
                raise RuntimeError("phases: clearing the clocks failed")
            kernel_call(case)()
            torch.cuda.synchronize()
            plan = tfm._grid(b, d, 64, tfm._sm_count(0))
        finally:
            restore()
        clocks, ns = np.zeros((2, 1024, 16), np.int64), np.zeros((2, 1024, 16), np.int64)
        if lib.phase_read(clocks.ctypes.data, ns.ctypes.data) != 0:
            raise RuntimeError("phases: reading the clocks failed")
        blocks = {"products": plan.splits * plan.k_chunks * plan.tiles,
                  "finish": -(-b // plan.finish_rows)}
        t0 = ns[0, :blocks["products"], 0].min()
        out = {}
        for k, (kernel, names) in enumerate(kernels.items()):
            c = clocks[k, :blocks[kernel], :len(names)]
            t = ns[k, :blocks[kernel], :len(names)] - t0
            out[kernel] = {
                "blocks": blocks[kernel],
                "median SM cycles": {n: int(np.median(np.diff(c, axis=1)[:, i]))
                                     for i, n in enumerate(names[:-1])},
                "max SM cycles": {n: int(np.max(np.diff(c, axis=1)[:, i]))
                                  for i, n in enumerate(names[:-1])},
                "ns from the first start: first start, last start, last end":
                    [int(t[:, 0].min()), int(t[:, 0].max()), int(t[:, -1].max())],
            }
            if kernel == "finish":
                out[kernel]["ns: last wait's end"] = int(t[:, names.index("sums")].max())
        print(f"[phases] {shape}, plan {tuple(plan)}: {json.dumps(out)}; card {smi}")


def profile(dev, smi: str) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
    from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
        MultiStreamRecognizer,
    )

    h, w = bench.SIZES["1080p"]
    frames, gallery_images, face, plants = bench.tracker_assets(STREAMS, (h, w), BATCHES, SEED,
                                                                dev)
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    msr = MultiStreamRecognizer(model, face, window=bench.WIN)
    boxes0 = np.stack([plants[0, :, 1], plants[0, :, 0], np.zeros(STREAMS), np.zeros(STREAMS)],
                      axis=1).astype(np.int32)

    def run_batches():
        state = msr.init_state(STREAMS, (h, w), boxes0)
        outs = []
        for f in range(BATCHES):
            out, state = msr.process_batch(frames[f], state)
            outs.append(out)
        torch.cuda.synchronize()
        return outs

    assert bench.planted_exact(run_batches(), plants), "process_batch planted-exact"
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_batches()
        wall.append((time.perf_counter() - t0) / BATCHES * 1e3)
    passes = 5
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            run_batches()
    rows = bench.device_kernels(prof)
    steps = passes * BATCHES
    total = sum(r[1] for r in rows) / steps
    print(f"[profile] tracker process_batch ({STREAMS} streams 1080p): device {total:.1f} us per "
          f"step over {steps} steps, host wall {[round(x, 3) for x in wall]} ms per step (busy "
          f"share {total / 1e3 / min(wall):.3f}); card {smi}")
    for key, us, count in rows[:12]:
        print(f"[profile]   {us / steps:.2f} us per step, {count / steps:g} launches: {key[:100]}")
    if not rows:
        print("[profile]   the trace holds no device time")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", action="store_true", help="time PLANS and VARIANTS")
    parser.add_argument("--phases", action="store_true", help="SM cycles per kernel phase")
    parser.add_argument("--profile", action="store_true", help="trace the tracker slice")
    args = parser.parse_args()
    dev = port_device.require_cuda()
    port_device.disable_tf32()
    smi = card()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    time_shapes(dev, smi)
    if args.phases:
        phases(dev, smi)
    if args.variants:
        sweep(dev, smi)
    if args.profile:
        profile(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
