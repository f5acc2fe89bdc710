"""Per-stage wall timers + optional ``torch.profiler`` traces (port of
``utils/profiling.py``).

Replaces the reference's every-N-frames progress prints
(``detection-v4.py:91-93``) with named stage accounting, and can wrap a
region in a profiler trace written as a Chrome trace (open it in
``chrome://tracing`` or Perfetto) for a timeline of the device's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {n} calls, {t / n * 1e3:.2f}ms avg")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a GPU is present) written to ``logdir/trace.json`` when
    a logdir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
