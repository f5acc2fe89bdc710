#!/usr/bin/env python3
"""Tile sweep and profile of the gallery-match kernel on one CUDA GPU.

    python3 scripts_torch/gallery_sweep.py [--variants] [--profile] [--probe]

``--variants`` builds copies of ``csrc/gallery_match.cu`` that differ only
in the constants that ``VARIANTS`` names (one nvcc per copy, all started
together, into ``build/sweep/``), prints each copy's registers and spills,
checks it against the plain version, and times it through
``ops.gallery_match.gallery_match`` on ``bench.large_gallery_assets`` data
(B 1024, k 128, seed 9) at N 131072 (the JAX per-chip shape) and
1,048,573, float32 and bf16, with the gallery as the ``.T`` view of its
rows, as ``sharded_gallery_match`` passes it.  Times are CUDA-event ms per
call, the variants taken in order and then in reverse order, and the two
averaged.

``--profile`` traces ``sharded_gallery_match`` on the (1, 1) and (1, 8)
meshes with the kernel as built, in both dtypes, with ``torch.profiler``:
device time per kernel and per call, against the host-clock time of a
synchronised call.

``--probe`` builds ``scripts_torch/hmma_probe.cu`` and measures the rate
of ``mma.sync`` alone on the card, bf16 m16n8k16 and TF32 m16n8k8, at 2,
4 and 8 warps per SM sub-partition: the ceiling of a kernel built on it.

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

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from face_detection_recognization_pca_tpu_torch import bench  # noqa: E402
from face_detection_recognization_pca_tpu_torch import device as port_device  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import _build  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import gallery_match as tgm  # noqa: E402
from face_detection_recognization_pca_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    sharded_gallery_match,
)

B, K, SEED = 1024, 128, 9
SHAPES = (131072, 1_048_573)
LB2 = r"__launch_bounds__\(kThreads, 2\)"
STAGES = r"kStages = sizeof\(T\) == 2 \? 3 : 2;"
TILES = r"constexpr int kTilesPerBlock = 16;"
# name -> (pattern, replacement) edits of csrc/gallery_match.cu.  The
# "without ..." variants drop one part of the work to show what it costs;
# their answers are wrong and only their times mean anything.
SPLIT = re.escape("  lo = rna_tf32(x - __uint_as_float(hi));")
PRODUCTS = r"    chunk_products<T, kGalleryRows>\(acc,[^;]*;\n"
VARIANTS = {
    "as built": [],
    "without the products": [(PRODUCTS, "")],
    "without the per-tile epilogue": [
        (r"if \(\+\+chunk < chunks\) continue;",
         "if (++chunk < chunks || s + 1 < steps) { if (chunk == chunks) { chunk = 0; ++tile; } "
         "continue; }")],
    "TF32 lo truncated, not rounded": [(SPLIT, "  lo = __float_as_uint(x - __uint_as_float(hi));")],
    "bf16 2 stages": [(STAGES, "kStages = 2;")],
    "1 block/SM": [(LB2, "__launch_bounds__(kThreads, 1)")],
    "8 N tiles a block": [(TILES, "constexpr int kTilesPerBlock = 8;")],
    "32 N tiles a block": [(TILES, "constexpr int kTilesPerBlock = 32;")],
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def build_variant(name: str) -> tuple:
    """(library, ptxas summary) of the source with VARIANTS[name] applied."""
    src = (_build.CSRC / "gallery_match.cu").read_text()
    for pattern, repl in VARIANTS[name]:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
    slug = re.sub(r"\W+", "_", name).strip("_")
    out = REPO / "build" / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{slug}.cu").write_text(src)
    lib = out / f"lib{slug}.so"
    proc = _build.nvcc(out / f"{slug}.cu", lib)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stdout + proc.stderr)
    return tgm._declare(ctypes.CDLL(str(lib))), f"regs {regs}, spill stores {spills}"


def sweep(dev, smi: str) -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    print(f"[sweep] {len(built)} variants built in {time.perf_counter() - t0:.1f} s")
    for name, (_, ptxas) in built.items():
        print(f"[sweep] {name}: {ptxas}")

    feats, gallery, _, _ = bench.large_gallery_assets(B, K, SHAPES[-1], SEED, dev)
    galleries = {dt: gallery.to(dt) for dt in (torch.float32, torch.bfloat16)}
    norms = {dt: torch.linalg.vector_norm(g, dim=1, dtype=torch.float32)
             for dt, g in galleries.items()}
    times = {name: {} for name in VARIANTS}
    as_built = tgm._lib
    try:
        for name, (lib, _) in built.items():  # correctness first
            tgm._lib = lambda lib=lib: lib
            for dt, g in galleries.items():
                n = SHAPES[0]
                idx_k, best_k = tgm.gallery_match(feats, g[:n].T, norms[dt][:n], operand_dtype=dt)
                idx_p, best_p = tgm._gallery_match_plain(feats, g[:n].T, norms[dt][:n],
                                                         operand_dtype=dt)
                torch.cuda.synchronize()
                print(f"[sweep] {name} {str(dt)[6:]} N={n}: ids equal to plain "
                      f"{float((idx_k == idx_p).float().mean()):.6f}, max|dbest| "
                      f"{float((best_k - best_p).abs().max()):.3g}")
        order = list(built) + list(reversed(built))
        for name in order:
            tgm._lib = lambda lib=built[name][0]: lib
            for dt, g in galleries.items():
                for n in SHAPES:
                    iters = 20 if n == SHAPES[0] else 5
                    ms = bench.cuda_time_ms(
                        lambda: tgm.gallery_match(feats, g[:n].T, norms[dt][:n], operand_dtype=dt),
                        iters, 2)
                    times[name].setdefault(f"{str(dt)[6:]} N={n}", []).append(ms)
    finally:
        tgm._lib = as_built
    for name, t in times.items():
        print(f"[sweep] {name}: CUDA-event ms per call (in order, in reverse) "
              + json.dumps({k: [round(x, 4) for x in v] for k, v in t.items()})
              + f"; card {smi}")


def profile(dev, smi: str) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    feats, gallery, labels, _ = bench.large_gallery_assets(B, K, SHAPES[-1], SEED, dev)
    meshes = {"(1,1)": make_mesh(1, 1), "(1,8)": make_mesh(1, 8, devices=[dev] * 8)}
    calls = 5
    for dt in (torch.float32, torch.bfloat16):
        g = gallery.to(dt)
        for mname, mesh in meshes.items():
            def run():
                return sharded_gallery_match(mesh, feats, g, labels)

            for _ in range(2):
                run()
            torch.cuda.synchronize()
            wall = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
            rows = bench.device_kernels(prof)
            total = sum(r[1] for r in rows) / calls / 1e3
            print(f"[profile] sharded_gallery_match {mname} {str(dt)[6:]} N={SHAPES[-1]}: "
                  f"device {total:.4f} ms per call, host wall {[round(w, 3) for w in wall]} ms "
                  f"(busy share {total / min(wall):.3f}); card {smi}")
            for key, us, count in rows[:8]:
                print(f"[profile]   {us / calls / 1e3:.4f} ms per call, {count // calls} "
                      f"launches: {key[:110]}")
            if not rows:
                print("[profile]   the trace holds no device time")


def probe(dev, smi: str) -> None:
    out_dir = REPO / "build" / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libhmma_probe.so"
    proc = _build.nvcc(REPO / "scripts_torch" / "hmma_probe.cu", lib_path)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on hmma_probe.cu\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.hmma_probe_tflops.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.hmma_probe_tflops.restype = ctypes.c_double
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, iters = 256, 20000
    for name, bf16 in (("bf16 m16n8k16", 1), ("tf32 m16n8k8", 0)):
        rates = {}
        for warps_per_subpartition in (2, 4, 8):
            blocks = sms * warps_per_subpartition * 4 // (threads // 32)
            out = torch.empty(blocks * threads, device=dev)
            rates[warps_per_subpartition] = lib.hmma_probe_tflops(bf16, blocks, threads, iters,
                                                                  out.data_ptr())
            if rates[warps_per_subpartition] < 0:
                raise RuntimeError(f"hmma probe failed: {rates}")
        print(f"[probe] mma.sync {name}: TFLOP/s by warps per sub-partition "
              f"{json.dumps({k: round(v, 1) for k, v in rates.items()})}; {sms} SMs; card {smi}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", action="store_true", help="build and time VARIANTS")
    parser.add_argument("--profile", action="store_true", help="trace sharded_gallery_match")
    parser.add_argument("--probe", action="store_true", help="rate of mma.sync alone")
    args = parser.parse_args()
    dev = port_device.require_cuda()
    port_device.disable_tf32()
    smi = card()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    if args.variants:
        sweep(dev, smi)
    if args.profile:
        profile(dev, smi)
    if args.probe:
        probe(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
