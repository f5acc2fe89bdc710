"""The tracker's one-process step replayed as a CUDA graph, one graph per frames buffer.

Without a mesh, on a CUDA device and on the NCC kernel's route, a step of
:class:`.multistream.MultiStreamRecognizer` enqueues about 30 launch calls
from Python (the window and crop gathers and their indices, the mean, the
``ncc_locate`` and ``fused_match`` launches, the next origins, the person
ids).  Replayed as a CUDA graph it makes three: the origins copied into
the graph's static input, the graph's launch, and one clone of its packed
outputs.  A replay runs the same kernels on the same operands, so it gives
the eager step's bits.

A graph is bound to the addresses it was captured with, so
:class:`StepGraphs` keys each one by its frames buffer (:func:`buffer_key`):
a replay reads whatever that buffer holds at the time, as a ring of decode
buffers or a pool of frame steps refilled in place does.  The first step on
a buffer runs eager, and with it the lazy set-up (the kernels' builds and
attributes); the second captures the buffer's graph and replays it; every
later one replays.  A buffer seen once never costs a capture.  At most
:data:`MAX_GRAPHS` graphs are captured and none is ever evicted: past that,
new buffers run eager, so a rotation of more buffers than that never
captures again and again.  Each step counts its path as
``multistream.graph.eager``, ``.capture`` or ``.replay``
(:func:`..utils.profiling.count`).

The graphs of one recognizer share one memory pool: replays run one after
another on one stream, each replay's outputs are cloned before the next,
and the static origins live outside the pool.  Nothing returned aliases
memory a later replay writes.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from face_detection_recognization_pca_tpu_torch.ops import fused_match as fused_match_op
from face_detection_recognization_pca_tpu_torch.ops import ncc_locate as ncc_locate_op
from face_detection_recognization_pca_tpu_torch.utils.profiling import count

# Graphs per recognizer: room for the frame pools and decode rings the tracker is fed from.
MAX_GRAPHS = 16

Results = Dict[str, torch.Tensor]
Step = Callable[[torch.Tensor, torch.Tensor], Tuple[Results, torch.Tensor]]


def buffer_key(frames: torch.Tensor) -> tuple:
    """What a graph captured on ``frames`` is bound to: its address and
    layout."""
    return (frames.data_ptr(), tuple(frames.shape), frames.stride(), frames.dtype, frames.device)


class StepGraphs:
    """Which path each step takes, by its frames buffer: ``step(frames,
    origin)`` at a buffer's first sight and once :data:`MAX_GRAPHS` are
    captured; ``capture(frames, origin, step)`` at its second, which
    returns the buffer's replayer and the step's outputs; the replayer
    ``(origin)`` after that.  Each path returns ``(results, next origin)``.
    The step is handed over at each call, not kept, so that a recognizer
    and its graphs form no reference cycle."""

    def __init__(self, capture: Callable):
        self._capture = capture
        self.graphs: Dict[tuple, Callable] = {}
        self._seen: set = set()  # keys seen once, while there is room for their graphs

    def __call__(self, frames: torch.Tensor, origin: torch.Tensor, step: Step):
        key = buffer_key(frames)
        graph = self.graphs.get(key)
        if graph is not None:
            count("multistream.graph.replay")
            return graph(origin)
        if key in self._seen:
            count("multistream.graph.capture")
            self._seen.discard(key)
            self.graphs[key], out = self._capture(frames, origin, step)
            if len(self.graphs) == MAX_GRAPHS:
                self._seen.clear()
            return out
        if len(self.graphs) < MAX_GRAPHS:
            self._seen.add(key)
        count("multistream.graph.eager")
        return step(frames, origin)


def pack(results: Results, next_origin: torch.Tensor) -> torch.Tensor:
    """A step's outputs as one ``(8, S)`` int32 tensor: gallery row, person
    id, x, y, the two float32 scores bit-cast, and the next origins' y and x."""
    return torch.stack([results["gallery_row"], results["person_id"], results["x"], results["y"],
                        results["confidence"].view(torch.int32),
                        results["template_confidence"].view(torch.int32),
                        next_origin[:, 0], next_origin[:, 1]])


def unpack(packed: torch.Tensor) -> Tuple[Results, torch.Tensor]:
    """:func:`pack`'s inverse, as views of ``packed``: the results dict and
    the ``(S, 2)`` next origins."""
    conf, tm_conf = packed[4:6].view(torch.float32)
    results = {"gallery_row": packed[0], "person_id": packed[1], "confidence": conf,
               "template_confidence": tm_conf, "x": packed[2], "y": packed[3]}
    return results, packed[6:8].T


def _launch_counters() -> List[Tuple[dict, str]]:
    """The counters that the hand-written kernels' wrappers bump at each
    launch, as ``(dict, key)``."""
    fused = fused_match_op.fused_match
    return [(ncc_locate_op.ncc_locate.__dict__, "launches"), (fused.__dict__, "launches"),
            (fused.fills, "tma"), (fused.fills, "elements")]


class StepGraph:
    """One captured step: called with the step's origins it copies them
    into the static input, replays, adds the kernels the replay ran to the
    wrappers' launch counters, counts ``counter`` and returns
    :func:`unpack` of a clone of the packed outputs."""

    def __init__(self, graph, origin_in: torch.Tensor, packed: torch.Tensor,
                 launched: List[Tuple[dict, str, int]], counter: str):
        self.graph, self.origin_in, self.packed = graph, origin_in, packed
        self.launched, self.counter = launched, counter

    def __call__(self, origin: torch.Tensor) -> Tuple[Results, torch.Tensor]:
        count(self.counter)
        return self.replay(origin)

    def replay(self, origin: torch.Tensor) -> Tuple[Results, torch.Tensor]:
        self.origin_in.copy_(origin.T)
        with torch.cuda.device(self.origin_in.device):
            self.graph.replay()
        for counter, key, n in self.launched:
            counter[key] += n
        return unpack(self.packed.clone())


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


class Capture:
    """Captures a step on a frames buffer into a graph of the shared pool:
    ``(frames, origin, step) -> (StepGraph, the step's outputs)``.  The
    graph reads the origins from a static ``(2, S)`` input kept per (S,
    frame shape) outside the pool, as ``(S, 2)`` views; ``counter`` is what
    the step counts once a step besides the launches
    (``multistream.ncc.kernel``), which a replay counts in its place."""

    def __init__(self, counter: str):
        self.counter = counter
        self.pool: Optional[tuple] = None
        self.origins: Dict[tuple, torch.Tensor] = {}

    def __call__(self, frames: torch.Tensor, origin: torch.Tensor, step: Step):
        device = frames.device
        origin_in = self.origins.get(frames.shape)
        if origin_in is None:
            origin_in = self.origins[frames.shape] = torch.empty(
                (2, frames.shape[0]), dtype=torch.int32, device=device)
        counters = _launch_counters()
        before = [counter[key] for counter, key in counters]
        with torch.cuda.device(device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            stream = _CAPTURE_STREAMS.get(device)
            if stream is None:
                stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            # A collection inside the capture could free another graph or a
            # tensor, which CUDA refuses on the capturing thread and which
            # ends the capture.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        results, next_origin = step(frames, origin_in.T)
                        packed = pack(results, next_origin)
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        # The capture ran nothing: the launches it counted are the replay's.
        launched = []
        for (counter, key), was in zip(counters, before):
            launched.append((counter, key, counter[key] - was))
            counter[key] = was
        captured = StepGraph(graph, origin_in, packed, launched, self.counter)
        return captured, captured.replay(origin)
