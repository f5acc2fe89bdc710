"""A ``torch.profiler`` trace read back as a device timeline.

The harness profiles a short window of calls, each inside a
``record_function`` range, and exports the trace as Chrome JSON; this
module reads it: every device operation (kernel, copy, set) with the
benchmark span the host was in when it launched it, the device's busy
time inside the window, and the idle gaps named by what the host was
doing.  The per-kernel sums follow the port's bench helpers
(``device_kernels``, ``kernel_families`` and ``_traced_windows`` in
``face_detection_recognization_pca_tpu_torch/bench.py``), taken over the
trace's events instead of ``key_averages()`` so that each kernel keeps its
place in time.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float  # us
    end: float  # us
    span: str  # innermost benchmark span at its launch, "" when none


class _Innermost:
    """The innermost of properly nested host ranges at any time."""

    def __init__(self, ranges: Iterable[Tuple[float, float, str]]):
        self.times: List[float] = []
        self.names: List[str] = []
        stack: List[Tuple[float, str]] = []
        for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= start:
                done, _ = stack.pop()
                self._mark(done, stack[-1][1] if stack else "")
            stack.append((end, name))
            self._mark(start, name)
        # Close what is still open, latest end last.
        while stack:
            done, _ = stack.pop()
            self._mark(done, stack[-1][1] if stack else "")

    def _mark(self, t: float, name: str) -> None:
        # Ranges that overlap without nesting would step back in time.
        t = max(t, self.times[-1]) if self.times else t
        if self.times and self.times[-1] == t:
            self.names[-1] = name
        else:
            self.times.append(t)
            self.names.append(name)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else ""


class Timeline:
    """The device operations the host launched inside one profiled window."""

    def __init__(self, events: Sequence[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        windows = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not windows:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        win = windows[0]
        self.window = (float(win["ts"]), float(win["ts"]) + float(win["dur"]))
        host = [e for e in xs if e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")]
        spans = _Innermost((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in host if e.get("cat") == "user_annotation")
        self._spans = spans
        self._ops = _Innermost((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                               for e in host if e.get("cat") != "user_annotation")
        launch_at: Dict[object, float] = {}
        for e in xs:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = float(e["ts"])
        self.ops: List[DeviceOp] = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            start = float(e["ts"])
            launched = launch_at.get(e.get("args", {}).get("correlation"))
            # Only the window's own work: what the host launched inside it.
            if not self.window[0] <= (start if launched is None else launched) <= self.window[1]:
                continue
            span = spans.at(launched) if launched is not None else ""
            self.ops.append(DeviceOp(e["name"], e["cat"], start, start + float(e["dur"]), span))
        self.ops.sort(key=lambda op: op.start)

    @staticmethod
    def load(path: str) -> "Timeline":
        with open(path) as f:
            data = json.load(f)
        return Timeline(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self, name_has: Optional[str] = None, span: Optional[str] = None) -> List[DeviceOp]:
        return [op for op in self.ops if op.cat == "kernel"
                and (name_has is None or name_has in op.name)
                and (span is None or op.span == span)]

    def _busy(self) -> List[Tuple[float, float]]:
        """The union of device operations, clipped to the window."""
        lo, hi = self.window
        merged: List[Tuple[float, float]] = []
        for op in self.ops:
            a, b = max(op.start, lo), min(op.end, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def idle_gaps(self, count: int = 10) -> List[Tuple[str, float]]:
        """The ``count`` longest stretches of the window with no device
        operation, each named ``span/op`` by what the host was in halfway
        through it."""
        lo, hi = self.window
        edges, t = [], lo
        for a, b in self._busy():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if hi > t:
            edges.append((t, hi))
        gaps = []
        for a, b in edges:
            mid = (a + b) / 2
            gaps.append((f"{self._spans.at(mid) or 'outside'}/{self._ops.at(mid) or 'python'}",
                         (b - a) * 1e-6))
        return sorted(gaps, key=lambda g: -g[1])[:count]

    def top_ops(self, count: int = 10) -> List[Tuple[str, float]]:
        """The ``count`` device operations that took most time in all, by
        name, in seconds."""
        totals: Dict[str, float] = {}
        for op in self.ops:
            totals[op.name] = totals.get(op.name, 0.0) + (op.end - op.start) * 1e-6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:count]


def union_s(ops: Sequence[DeviceOp]) -> float:
    """Seconds covered by ``ops`` together."""
    total, end = 0.0, float("-inf")
    for op in sorted(ops, key=lambda o: o.start):
        if op.end > end:
            total += op.end - max(op.start, end)
            end = op.end
    return total * 1e-6
