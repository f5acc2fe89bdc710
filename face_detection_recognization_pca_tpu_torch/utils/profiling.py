"""The port's tracer: named spans and counters inside the program, plus
optional ``torch.profiler`` traces (port of ``utils/profiling.py``).

Replaces the reference's every-N-frames progress prints
(``detection-v4.py:91-93``) with named stage accounting.  The layers mark
their stages with :func:`span` and count what they saw with :func:`count`:

    with profiling.span("haar.group"):
        ...
    profiling.count("scan.faces")

Tracing is off by default, and then a span is a flag check and the
profiler's own "am I running" test that return one shared null context:
no clock read, no ``record_function``, nothing kept.  It is on only while
:func:`enable` holds it on.  When on, each span keeps its name, the span
it opened inside, a call id shared by every span under one outermost
span, and its start and end on ``time.perf_counter_ns``.  Whenever a
``torch.profiler`` runs, on or off, a span is also a range of the same
name in the profiler's trace (a ``cpu_op`` event, beside the ``aten::``
operators it encloses), so it lies on the device trace's own clock and a
kernel can be told by the innermost span its launch ran in; with tracing
off that range is all it is.

No span synchronises the device.  A span's time is host time: the enqueue
of the work inside it, plus any wait for the device that the work itself
makes (a ``.item()``, an event's ``synchronize``, a copy to pageable
memory).  Device time comes from the profiler's trace.

:func:`device_trace` wraps a region in a profiler trace written as a
Chrome trace (open it in ``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

import torch

from face_detection_recognization_pca_tpu_torch.utils.logging import Counters

# Spans kept for snapshot(); the per-name totals of summary() are not capped.
MAX_RECORDS = 1 << 16

_profiler_running = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # the span it opened inside, None when outermost
    call: int  # shared by every span under one outermost span
    start_ns: int  # time.perf_counter_ns
    end_ns: int


_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _profiler_range(name: str):
    """A ``cpu_op`` range of ``name`` in the running profiler's trace, or
    None on a PyTorch without one.  Not ``record_function``: its ranges are
    ``user_annotation`` events, which a trace's reader takes for the
    caller's own spans."""
    return _RANGE(name) if _RANGE is not None else None


class _Span:
    """One open span: the context manager :func:`span` returns while on."""

    __slots__ = ("tracer", "name", "call", "start", "children", "mark")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.children = tracer, name, 0

    def __enter__(self) -> None:
        tracer = self.tracer
        stack = tracer._stack()
        if stack:
            self.call = stack[-1].call
        else:
            with tracer._lock:
                tracer._calls += 1
                self.call = tracer._calls
        self.mark = _profiler_range(self.name) if _profiler_running() else None
        if self.mark is not None:
            self.mark.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        stack = self.tracer._stack()
        stack.pop()
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.children += end - self.start
        self.tracer._close(self, parent.name if parent else None, end)


class Tracer:
    """Spans and counters of one process; :data:`TRACER` is the one the
    program's layers write to."""

    def __init__(self) -> None:
        self.on = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter kept so far."""
        with self._lock:
            self.records: Deque[SpanRecord] = deque(maxlen=MAX_RECORDS)
            # name -> [count, total ns, ns covered by its children]
            self.totals: Dict[str, List[int]] = {}
            self.counters = Counters()
            self._calls = 0

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters.inc(name, n)

    def _close(self, span: _Span, parent: Optional[str], end: int) -> None:
        took = end - span.start
        with self._lock:
            self.records.append(SpanRecord(span.name, parent, span.call, span.start, end))
            total = self.totals.get(span.name)
            if total is None:
                total = self.totals[span.name] = [0, 0, 0]
            total[0] += 1
            total[1] += took
            total[2] += span.children

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def snapshot(self) -> dict:
        """What was kept since the last :meth:`reset`: ``spans`` (the
        :class:`SpanRecord` of each span in the order they closed, the
        last :data:`MAX_RECORDS`), ``counters``, and ``totals``
        per span name: ``(count, total_s, self_s)``."""
        with self._lock:
            return {
                "spans": list(self.records),
                "counters": self.counters.as_dict(),
                "totals": {name: (n, total * 1e-9, (total - children) * 1e-9)
                           for name, (n, total, children) in self.totals.items()},
            }

    def summary(self) -> str:
        """One line per span name, most total time first: count, total and
        self time (the span less what its child spans cover), host clock;
        then the counters."""
        snap = self.snapshot()
        lines = [f"{name}: {n} spans, {total * 1e3:.3f} ms total, {own * 1e3:.3f} ms self"
                 for name, (n, total, own) in sorted(snap["totals"].items(),
                                                      key=lambda kv: -kv[1][1])]
        lines += [f"{name}: {value}" for name, value in sorted(snap["counters"].items())]
        return "\n".join(lines)


_NULL = contextlib.nullcontext()
TRACER = Tracer()


def span(name: str):
    """A context manager that marks a stage named ``name`` while tracing is
    on, and is a range of the running profiler's trace with tracing off
    (see the module's docstring); a shared null context otherwise."""
    if TRACER.on:
        return _Span(TRACER, name)
    mark = _profiler_range(name) if _profiler_running() else None
    return _NULL if mark is None else mark


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if TRACER.on:
        TRACER.count(name, n)


def enable(on: bool = True) -> None:
    """Turn tracing on or off."""
    TRACER.on = bool(on)


def reset() -> None:
    TRACER.reset()


def snapshot() -> dict:
    return TRACER.snapshot()


def summary() -> str:
    return TRACER.summary()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a GPU is present) written to ``logdir/trace.json`` when
    a logdir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
