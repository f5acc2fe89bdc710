"""The program's spans in the profiler's trace, read beside the harness's
own: the accepted readers read the same with them as without, the new
reader and ``benchmark.stages`` give the values worked out by hand, and a
traced run of the Haar cell on the CPU leaves the tracer off and empty
(the harness does not enable it)."""

from types import SimpleNamespace

import pytest

from benchmark import stages
from benchmark.harness import HERE, load_module
from benchmark.timeline import Timeline
from conftest import run_cell

FUSED = ("void (anonymous namespace)::fused_match_products<true, 128>(CUtensorMap, float const*, "
         "float*, int, int, int)")
FINISH = "void (anonymous namespace)::fused_match_finish<8, false>(float*, int)"


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 1, correlation=corr)


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def read(name):
    return load_module(HERE / "metrics" / f"{name}.py", "t_tracer_" + name.replace(".", "_")).read


def tracker_trace(program: bool):
    """Two calls of the tracker step, each launching a gemm in the
    numerator, an elementwise kernel in the statistics, a gather in the
    crops and the fused match's two kernels; with ``program`` the step's
    spans are ``cpu_op`` ranges around them."""
    events = [_x("bench.window", "user_annotation", 0, 400)]
    for c, t in enumerate((0, 200)):
        corr = 10 * c
        events += [_x("bench.call", "user_annotation", t + 1, 190),
                   _x("multistream.process_batch", "user_annotation", t + 2, 150),
                   _launch(t + 20, corr), _kernel("gemm_numerator", t + 30, 40, corr),
                   _launch(t + 50, corr + 1), _kernel("elementwise_scores", t + 70, 20, corr + 1),
                   _launch(t + 80, corr + 2), _kernel("index_crops", t + 90, 5, corr + 2),
                   _launch(t + 100, corr + 3), _kernel(FUSED, t + 100, 12, corr + 3),
                   _launch(t + 110, corr + 4), _kernel(FINISH, t + 112, 6, corr + 4),
                   # After the step, inside the entry: the labels' gather.
                   _launch(t + 140, corr + 5), _kernel("labels_index", t + 141, 2, corr + 5),
                   _x("aten::index", "cpu_op", t + 138, 5)]
        if program:
            events += [_x("multistream.step", "cpu_op", t + 10, 120),
                       _x("multistream.numerator", "cpu_op", t + 15, 30),
                       _x("multistream.statistics", "cpu_op", t + 48, 25),
                       _x("multistream.crops", "cpu_op", t + 78, 10),
                       _x("multistream.match", "cpu_op", t + 95, 25)]
    return events


def haar_trace(program: bool):
    """One call of the Haar scan: an upload copy, a level's integral and
    dense pass, the grouping on the host with the device idle, and one
    recognition."""
    events = [_x("bench.window", "user_annotation", 0, 300),
              _x("bench.call", "user_annotation", 1, 290),
              _launch(5, 1, "cudaMemcpyAsync"),
              {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 6, "dur": 4, "pid": 0,
               "tid": 7, "args": {"correlation": 1}},
              _x("haar.detect", "user_annotation", 20, 180),
              _launch(30, 2), _kernel("cumsum", 31, 20, 2),
              _launch(60, 3), _kernel("stages_pass", 61, 30, 3),
              _launch(100, 4), _kernel("nonzero", 101, 10, 4),
              _launch(210, 5), _kernel("recognize_gemm", 211, 10, 5)]
    if program:
        events += [_x("scan.upload", "cpu_op", 3, 10),
                   _x("haar.integral", "cpu_op", 25, 30),
                   _x("haar.dense", "cpu_op", 58, 30),
                   _x("haar.candidates", "cpu_op", 95, 20),
                   _x("haar.group", "cpu_op", 120, 70),
                   _x("scan.recognize", "cpu_op", 205, 30)]
    return events


def _tracker_run(events):
    return SimpleNamespace(timeline=Timeline(events), profiled_calls=2, traffic={"streams": 512},
                           config={"template": 96, "components": 64, "gallery": 256})


@pytest.mark.parametrize("reader", ["step_math.device_ms", "fused_match_roofline",
                                    "device.idle_share"])
def test_the_accepted_tracker_readers_read_the_same_with_program_spans(reader):
    plain = read(reader)(_tracker_run(tracker_trace(False)))
    assert plain is not None
    assert read(reader)(_tracker_run(tracker_trace(True))) == plain


@pytest.mark.parametrize("reader", ["haar.device_ms", "device.idle_share"])
def test_the_accepted_haar_readers_read_the_same_with_program_spans(reader):
    def run(program):
        return SimpleNamespace(timeline=Timeline(haar_trace(program)), profiled_calls=1)

    plain = read(reader)(run(False))
    assert plain is not None
    assert read(reader)(run(True)) == plain
    if reader == "haar.device_ms":
        assert plain == pytest.approx(0.060)


def test_the_kernels_keep_the_benchmark_span_and_take_the_program_stage():
    names = {"multistream.step", "multistream.numerator", "multistream.statistics",
             "multistream.crops", "multistream.match"}
    st = stages.Stages(tracker_trace(True), names)
    assert [op.span for op in st.ops] == [k.span for k in Timeline(tracker_trace(False)).ops]
    per_call = st.by_stage(2)
    assert per_call["multistream.numerator"] == {"device_ms": pytest.approx(0.040),
                                                 "launches": 1.0}
    assert per_call["multistream.statistics"]["device_ms"] == pytest.approx(0.020)
    assert per_call["multistream.crops"]["device_ms"] == pytest.approx(0.005)
    assert per_call["multistream.match"] == {"device_ms": pytest.approx(0.018), "launches": 2.0}
    assert per_call["(none)"] == {"device_ms": pytest.approx(0.002), "launches": 1.0}
    # The step's stages and the fused match make up step_math plus the match.
    step = sum(v["device_ms"] for k, v in per_call.items() if k.startswith("multistream."))
    assert step + 0.002 == pytest.approx(read("step_math.device_ms")(
        _tracker_run(tracker_trace(True))) + 0.018)


def test_launches_per_step_count_the_calls_inside_the_step_only():
    assert stages.launches_per_step(Timeline(tracker_trace(True))) == 5.0
    # Without the program's step span there is nothing to count.
    assert stages.launches_per_step(Timeline(tracker_trace(False))) is None
    assert read("multistream.launches")(_tracker_run(tracker_trace(True))) == 5.0
    # A timeline that no longer keeps its host operations fails loudly.
    with pytest.raises(AttributeError):
        stages.launches_per_step(SimpleNamespace(window=(0, 400)))


def test_an_idle_gap_in_the_grouping_is_named_by_its_span():
    names = {"scan.upload", "haar.integral", "haar.dense", "haar.candidates", "haar.group",
             "scan.recognize"}
    st = stages.Stages(haar_trace(True), names)
    assert st.idle_gaps()[0] == ("haar.group/python", pytest.approx(100e-6))
    assert st.by_stage(1)["haar.integral"]["device_ms"] == pytest.approx(0.020)
    assert st.device_s(stage="haar.dense") + st.device_s(stage="haar.candidates") == \
        pytest.approx(40e-6)
    assert st.device_s(span="haar.detect") == pytest.approx(60e-6)
    # The accepted timeline names the same gap by the harness's span and the
    # program's range, the innermost host operation there.
    assert Timeline(haar_trace(True)).idle_gaps()[0] == ("haar.detect/haar.group",
                                                         pytest.approx(100e-6))
    assert Timeline(haar_trace(False)).idle_gaps()[0] == ("haar.detect/python",
                                                          pytest.approx(100e-6))


def test_host_ms_per_call_by_span_and_per_face():
    snap = {"spans": [], "counters": {"scan.faces": 6, "haar.windows": 600},
            "totals": {"scan.upload": (2, 0.008, 0.008), "haar.group": (2, 0.006, 0.006),
                       "scan.recognize": (2, 0.0045, 0.0045)}}
    got = stages.host_ms(snap, 2)
    assert got == pytest.approx({"haar.group": 3.0, "scan.recognize": 2.25, "scan.upload": 4.0,
                                 "scan.recognize per face": 0.75})
    # Without a count of faces there is no per-face figure.
    del snap["counters"]["scan.faces"]
    assert "scan.recognize per face" not in stages.host_ms(snap, 2)


def test_a_traced_haar_run_leaves_the_tracer_off_and_empty(tiny_root):
    import importlib

    profiling = importlib.import_module(stages.PROFILING)
    profiling.reset()
    rc, result, err = run_cell(tiny_root, "haar-scan-544p.faces1", trace=True)
    assert rc == 0, err
    assert not profiling.TRACER.on
    assert profiling.snapshot() == {"spans": [], "counters": {}, "totals": {}}
    # The CPU traced no device: the accepted readers' metrics alone.
    assert set(result["metrics"]) == {"haar.detect_ms", "scan.outside_detect_ms"}
