"""The port's tracer (``utils/profiling``): off it keeps nothing and, with
no profiler running, opens no range; on it keeps names, parents, call
ids, counts and self times; under a ``torch.profiler`` its spans are
ranges of the trace nested as opened, on or off; and the tracker step,
the Haar detector and the Haar scan give the same bits with it on as
off, with each of their spans and counters where the layers put them.
No JAX here."""

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch.detect import haar as thaar
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms
from face_detection_recognization_pca_tpu_torch.pipeline import scan_app as tscan
from face_detection_recognization_pca_tpu_torch.recognize import engine as tengine
from face_detection_recognization_pca_tpu_torch.utils import profiling
from haar_scenes import frames180, video_frames

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _names(snap=None):
    return [r.name for r in (snap or profiling.snapshot())["spans"]]


def _counts(snap=None):
    return {name: n for name, (n, _, _) in (snap or profiling.snapshot())["totals"].items()}


def test_off_a_span_reads_no_clock_opens_no_range_and_keeps_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("touched while tracing is off")

    monkeypatch.setattr(profiling, "_profiler_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    assert not profiling.TRACER.on
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second
    with first:
        with profiling.span("c"):
            profiling.count("n", 3)
    snap = profiling.snapshot()
    assert snap == {"spans": [], "counters": {}, "totals": {}}
    assert profiling.summary() == ""


def test_on_spans_keep_names_parents_calls_and_self_time(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    monkeypatch.setattr(profiling, "_profiler_range",
                        lambda name: pytest.fail("no profiler runs"))
    profiling.enable(True)
    assert profiling.TRACER.on
    with profiling.span("outer"):  # start 0
        with profiling.span("inner"):  # 10 .. 20
            profiling.count("seen")
        with profiling.span("inner"):  # 30 .. 40
            profiling.count("seen", 4)
    # end 50
    with profiling.span("outer"):  # 60 .. 70
        pass
    snap = profiling.snapshot()
    got = [(r.name, r.parent, r.call, r.start_ns, r.end_ns) for r in snap["spans"]]
    assert got == [("inner", "outer", 1, 10, 20), ("inner", "outer", 1, 30, 40),
                   ("outer", None, 1, 0, 50), ("outer", None, 2, 60, 70)]
    assert snap["counters"] == {"seen": 5}
    assert snap["totals"]["outer"] == pytest.approx((2, 60e-9, 40e-9))
    assert snap["totals"]["inner"] == pytest.approx((2, 20e-9, 20e-9))
    lines = profiling.summary().splitlines()
    assert lines[0].startswith("outer: 2 spans, ") and lines[1].startswith("inner: 2 spans, ")
    assert lines[2] == "seen: 5"
    profiling.enable(False)
    with profiling.span("outer"):
        profiling.count("seen")
    assert len(profiling.snapshot()["spans"]) == 4
    profiling.reset()
    assert profiling.snapshot() == {"spans": [], "counters": {}, "totals": {}}


def test_a_span_closes_on_an_exception_and_keeps_its_record():
    profiling.enable(True)
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError("stage failed")
    assert [(r.name, r.parent) for r in profiling.snapshot()["spans"]] == [
        ("inner", "outer"), ("outer", None)]
    with profiling.span("next"):
        pass
    assert profiling.snapshot()["spans"][-1].parent is None


def test_threads_keep_their_own_nesting_and_lose_no_update():
    profiling.enable(True)
    threads, per = 12, 150
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(per):
                with profiling.span(f"t{i}"):
                    with profiling.span(f"t{i}.child"):
                        profiling.count("n")

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    snap = profiling.snapshot()
    assert snap["counters"] == {"n": threads * per}
    assert len(snap["totals"]) == 2 * threads
    assert all(n == per for n, _, _ in snap["totals"].values())
    for r in snap["spans"]:
        assert r.parent == (r.name[:-len(".child")] if r.name.endswith(".child") else None)
    calls = {r.call for r in snap["spans"]}
    assert len(calls) == threads * per


def test_under_a_profiler_spans_are_kept_and_nest_as_ranges_of_the_trace(tmp_path):
    """Under a profiler every span is a range of the trace, nested as
    opened; it is kept in the tracer's record only while tracing is on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def trace(name):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench.call"):
                with profiling.span("outer"):
                    a = torch.ones(64) + 1
                    with profiling.span("inner"):
                        (a * 2).sum()
                        profiling.count("seen")
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def inside(e, o):
        return o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]

    for on in (False, True):
        profiling.enable(on)
        xs = trace(f"on{on}")
        assert profiling.TRACER.on is on
        by_name = {e["name"]: e for e in xs if e["name"] in ("bench.call", "outer", "inner")}
        assert set(by_name) == {"bench.call", "outer", "inner"}
        assert by_name["bench.call"]["cat"] == "user_annotation"
        # The program's spans are not user annotations: a reader that names a
        # kernel by the innermost annotation still sees the benchmark's own.
        assert by_name["outer"]["cat"] == by_name["inner"]["cat"] == "cpu_op"
        assert inside(by_name["inner"], by_name["outer"])
        assert inside(by_name["outer"], by_name["bench.call"])
        mul = [e for e in xs if e["name"] == "aten::mul"]
        assert mul and all(inside(e, by_name["inner"]) for e in mul)
        snap = profiling.snapshot()
        if on:
            assert _names(snap) == ["inner", "outer"] and snap["counters"] == {"seen": 1}
        else:
            assert snap == {"spans": [], "counters": {}, "totals": {}}


STEP_SPANS = ("multistream.step", "multistream.windows", "multistream.ncc",
              "multistream.crops", "multistream.match")


def test_process_batch_and_window_give_the_same_bits_traced_with_each_stage_once():
    streams, (h, w), batches = 2, (480, 640), 2
    frames, gallery_images, face, plants = tbench.tracker_assets(
        streams, (h, w), batches, 4, CPU)
    model, _ = tef.train_v1(gallery_images, n_components=16)
    msr = tms.MultiStreamRecognizer(model, face, window=tbench.WIN)
    boxes0 = np.stack([plants[0, :, 1], plants[0, :, 0], np.zeros(streams),
                       np.zeros(streams)], 1).astype(np.int32)

    def run():
        state = msr.init_state(streams, (h, w), boxes0)
        outs = []
        for f in range(batches):
            out, state = msr.process_batch(frames[f], state)
            outs.append(out)
        wout, wstate = msr.process_window(frames, msr.init_state(streams, (h, w), boxes0))
        return outs, state, wout, wstate

    off = run()
    assert profiling.snapshot()["spans"] == []
    profiling.enable(True)
    on = run()
    for a, b in zip(off[0] + [off[2]], on[0] + [on[2]]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(off[1].origin, on[1].origin) and torch.equal(off[3].origin, on[3].origin)
    snap = profiling.snapshot()
    steps = 2 * batches  # process_batch per frame, then process_window's frames
    assert _counts(snap) == {name: steps for name in STEP_SPANS}
    assert snap["counters"] == {"multistream.ncc.plain": steps}  # the CPU's route, once a step
    for r in snap["spans"]:
        assert r.parent == (None if r.name == "multistream.step" else "multistream.step")
    assert len({r.call for r in snap["spans"]}) == steps


def test_the_haar_detector_gives_the_same_boxes_traced_with_its_spans_and_counts():
    detector = thaar.HaarDetector(device=CPU)
    grays = frames180()
    off = detector.detect_multi_scale_batch(grays)
    profiling.enable(True)
    handle = detector.detect_device(grays)
    on = detector.detect_finish(handle)
    assert on == off and any(on)
    snap = profiling.snapshot()
    levels = len(handle["levels"])
    # No download span on the CPU: the rows are already in host memory.
    assert _counts(snap) == {"haar.integral": levels, "haar.dense": levels,
                             "haar.candidates": 1, "haar.group": 1}
    assert all(r.parent is None for r in snap["spans"])
    counters = snap["counters"]
    assert counters["haar.windows"] == handle["windows"] * len(grays)
    stages = {int(k.rsplit(".", 1)[1]): v for k, v in counters.items()
              if k.startswith("haar.candidates.")}
    assert stages == dict(handle["survivors"])
    grouped = counters.get("haar.group.native", 0) + counters.get("haar.group.numpy", 0)
    assert grouped == len(np.unique(handle["rows"].numpy()[:, 0]))


def test_the_haar_path_taken_by_grouping_is_counted(monkeypatch):
    from face_detection_recognization_pca_tpu_torch.io import native

    rects = [(10, 10, 40, 40)] * 4
    profiling.enable(True)
    monkeypatch.setattr(native, "group_rectangles_native", lambda *a: None)
    numpy_boxes = thaar.group_rectangles(rects, 2)
    monkeypatch.setattr(native, "group_rectangles_native", lambda *a: [(10, 10, 40, 40)])
    assert thaar.group_rectangles(rects, 2) == numpy_boxes == [(10, 10, 40, 40)]
    assert thaar.group_rectangles([], 2) == []
    assert profiling.snapshot()["counters"] == {"haar.group.numpy": 1, "haar.group.native": 1}


def test_the_haar_scan_gives_the_same_records_traced_with_a_span_per_face():
    frames = video_frames()
    face = (64, 64)
    artifacts = []
    for person in (1, 2):
        crops = np.stack([np.resize(tbench.haar_face(64 + 2 * i, person), face)
                          for i in range(12)]).astype(np.float32)
        rows = torch.from_numpy(crops.reshape(len(crops), -1))
        model, aux = tef.train_v2(rows, torch.zeros(len(rows), dtype=torch.int32),
                                  n_components=6, face_shape=face)
        artifacts.append((f"p{person}", tef.to_artifact(
            model, aux, person_id_map={f"p{person}": 0}, person_name=f"p{person}")))
    stack = tengine.ModelStack.build(artifacts, device=CPU)
    detector = thaar.HaarDetector(device=CPU)
    off = tscan.scan_frames_haar_multimodel(iter(frames), stack, detector=detector)
    profiling.enable(True)
    on = tscan.scan_frames_haar_multimodel(iter(frames), stack, detector=detector)
    assert on == off and off
    snap = profiling.snapshot()
    counts = _counts(snap)
    assert counts["scan.upload"] == counts["haar.group"] == 1  # six frames: one batch
    assert counts["scan.recognize"] == snap["counters"]["scan.faces"] == len(off)
    assert all(r.parent is None for r in snap["spans"])
