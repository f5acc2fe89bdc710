"""The tracker step's CUDA graphs (``parallel/step_graph.py``) on the CPU:
the rule that picks each step's path, with stubs in place of the capture,
the packing of a step's outputs, and the paths that never capture (the
CPU and a one-process mesh).  The graphs themselves run in
``tests/test_torch_gpu.py``.  No JAX here."""

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu_torch import bench
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
from face_detection_recognization_pca_tpu_torch.parallel import mesh as tmesh
from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms
from face_detection_recognization_pca_tpu_torch.parallel import step_graph as sg
from face_detection_recognization_pca_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture()
def traced():
    profiling.reset()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.reset()


def _paths():
    return {name.rsplit(".", 1)[1]: n for name, n in profiling.snapshot()["counters"].items()
            if name.startswith("multistream.graph.")}


class _Stubs:
    """A step (``eager``) and a ``capture`` for :class:`sg.StepGraphs` that
    log which buffer took which path; a replayer logs its replays."""

    def __init__(self):
        self.log = []

    def eager(self, frames, origin):
        self.log.append(("eager", frames.data_ptr()))
        return "eager", origin

    def capture(self, frames, origin, step):
        assert step == self.eager
        self.log.append(("capture", frames.data_ptr()))
        ptr = frames.data_ptr()

        def replay(origin):
            self.log.append(("replay", ptr))
            return "replay", origin

        return replay, ("captured", origin)


def test_a_buffer_is_told_by_its_address_and_layout():
    pool = torch.zeros(3, 4, 6)
    assert sg.buffer_key(pool[1]) == sg.buffer_key(pool[1])
    assert sg.buffer_key(pool[1]) == sg.buffer_key(pool.unbind(0)[1])
    keys = {sg.buffer_key(t) for t in (pool[0], pool[1], pool[1].reshape(6, 4), pool[1].T,
                                       pool[1].view(torch.int32), pool[1, :2])}
    assert len(keys) == 6


def test_a_buffer_runs_eager_then_captures_at_its_second_sight_then_replays(traced):
    stubs = _Stubs()
    graphs = sg.StepGraphs(stubs.capture)
    pool = torch.zeros(3, 2, 2)
    origin = torch.zeros(2, 2, dtype=torch.int32)
    paths = [graphs(pool[i % 3], origin, stubs.eager)[0] for i in range(12)]
    assert paths == ["eager"] * 3 + ["captured"] * 3 + ["replay"] * 6
    assert [ptr for _, ptr in stubs.log[:3]] == [pool[i].data_ptr() for i in range(3)]
    assert _paths() == {"eager": 3, "capture": 3, "replay": 6}
    assert len(graphs.graphs) == 3


def test_a_buffer_seen_once_never_captures(traced):
    stubs = _Stubs()
    graphs = sg.StepGraphs(stubs.capture)
    pool = torch.zeros(sg.MAX_GRAPHS * 3, 2, 2)
    origin = torch.zeros(2, 2, dtype=torch.int32)
    assert all(graphs(frames, origin, stubs.eager)[0] == "eager" for frames in pool)
    assert not graphs.graphs and _paths() == {"eager": len(pool)}


@pytest.mark.parametrize("extra", [1, 5])
def test_past_the_cap_new_buffers_run_eager_and_no_graph_is_evicted(traced, extra):
    stubs = _Stubs()
    graphs = sg.StepGraphs(stubs.capture)
    pool = torch.zeros(sg.MAX_GRAPHS + extra, 2, 2)
    origin = torch.zeros(2, 2, dtype=torch.int32)
    rounds = [[graphs(frames, origin, stubs.eager)[0] for frames in pool] for _ in range(4)]
    assert rounds[0] == ["eager"] * len(pool)
    assert rounds[1] == ["captured"] * sg.MAX_GRAPHS + ["eager"] * extra
    assert rounds[2] == rounds[3] == ["replay"] * sg.MAX_GRAPHS + ["eager"] * extra
    assert _paths() == {"eager": len(pool) + 3 * extra, "capture": sg.MAX_GRAPHS,
                        "replay": 2 * sg.MAX_GRAPHS}
    assert set(graphs.graphs) == {sg.buffer_key(frames) for frames in pool[:sg.MAX_GRAPHS]}
    # A buffer first seen once the cap is full never captures either.
    late = torch.zeros(2, 2)
    assert [graphs(late, origin, stubs.eager)[0] for _ in range(3)] == ["eager"] * 3


def test_pack_and_unpack_keep_every_bit():
    gen = torch.Generator().manual_seed(3)
    s = 7
    ints = {key: torch.randint(-2**31, 2**31 - 1, (s,), generator=gen, dtype=torch.int32)
            for key in ("gallery_row", "person_id", "x", "y")}
    floats = {key: torch.randint(-2**31, 2**31 - 1, (s,), generator=gen,
                                 dtype=torch.int32).view(torch.float32)
              for key in ("confidence", "template_confidence")}
    results = {**ints, **floats}
    origin = torch.randint(0, 1000, (s, 2), generator=gen, dtype=torch.int32)
    packed = sg.pack(results, origin)
    assert packed.shape == (8, s) and packed.dtype == torch.int32
    got, got_origin = sg.unpack(packed)
    assert list(got) == ["gallery_row", "person_id", "confidence", "template_confidence", "x",
                         "y"]
    for key, want in results.items():
        assert got[key].dtype == want.dtype and got[key].shape == (s,), key
        assert torch.equal(got[key].view(torch.int32), want.view(torch.int32)), key
        assert got[key].data_ptr() >= packed.data_ptr()  # a view of the packed outputs
    assert got_origin.shape == (s, 2) and torch.equal(got_origin, origin)
    assert got_origin.T.is_contiguous()  # copied into the static (2, S) input by one memcpy


@pytest.fixture(scope="module")
def tracker():
    streams, hw = 2, (480, 640)
    frames, gallery_images, face, plants = bench.tracker_assets(streams, hw, 2, 4,
                                                                torch.device("cpu"))
    model, _ = train_v1(gallery_images, n_components=16)
    boxes0 = np.stack([plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)],
                      1).astype(np.int32)
    return model, face, frames, boxes0, hw


@pytest.mark.parametrize("where", ["cpu", "one-process mesh"])
@pytest.mark.parametrize("entry", ["process_batch", "process_window"])
def test_the_step_never_captures_on_the_cpu_or_a_mesh(tracker, traced, where, entry):
    """The same buffers three times over: every step runs eager as before,
    counts no ``multistream.graph.*`` path and gives the same bits each
    time."""
    model, face, frames, boxes0, hw = tracker
    mesh = tmesh.make_mesh(1, 1, devices=["cpu"]) if where != "cpu" else None
    msr = tms.MultiStreamRecognizer(model, face, window=bench.WIN, mesh=mesh)
    assert msr._graphs is None
    state = msr.init_state(frames.shape[1], hw, boxes0)
    if entry == "process_batch":
        outs = [msr.process_batch(frames[0], state) for _ in range(3)]
    else:
        outs = [msr.process_window(frames, state) for _ in range(3)]
    for out, next_state in outs[1:]:
        assert all(torch.equal(out[key], outs[0][0][key]) for key in out)
        assert torch.equal(next_state.origin, outs[0][1].origin)
    counters = profiling.snapshot()["counters"]
    steps = 3 * (1 if entry == "process_batch" else frames.shape[0])
    assert counters == {"multistream.ncc.plain": steps}
