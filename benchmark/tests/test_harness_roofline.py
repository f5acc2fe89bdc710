"""The roofline arithmetic and the trace reading, on numbers worked out
by hand."""

import pytest

from benchmark import roofline
from benchmark.timeline import Timeline, union_s


@pytest.mark.parametrize("b, micros", [(512, 6.36), (64, 1.43)])
def test_the_fused_match_bound_at_the_tracker_shapes(b, micros):
    bound = roofline.fused_match(b, 96 * 96, 64, 256)
    assert bound.by == "bytes"
    assert bound.seconds * 1e6 == pytest.approx(micros, abs=0.005)


def test_the_tracker_frame_count_is_below_the_dft_matmul_count():
    counted = roofline.tracker_frame_flops(192, 96, 64, 256)
    # The port's DFT-as-matmul NCC alone does 12 n^3 for the forward pass.
    assert 3e6 < counted < 12 * 192 ** 3


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def test_a_trace_is_read_into_busy_time_spans_and_named_gaps():
    events = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.call", "user_annotation", 1, 90),
        _x("haar.detect", "user_annotation", 5, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 60, 2, correlation=2),
        _x("aten::nonzero", "cpu_op", 40, 20),
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 12, "dur": 18, "pid": 0, "tid": 7,
         "args": {"correlation": 1}},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 70, "dur": 10, "pid": 0, "tid": 7,
         "args": {"correlation": 2}},
        # Launched before the window opened: not the window's work.
        _x("cudaLaunchKernel", "cuda_runtime", -9, 2, correlation=3),
        {"ph": "X", "name": "k0", "cat": "kernel", "ts": -5, "dur": 9, "pid": 0, "tid": 7,
         "args": {"correlation": 3}},
    ]
    tl = Timeline(events)
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.busy_s == pytest.approx(28e-6)
    assert [k.span for k in tl.kernels()] == ["haar.detect", "bench.call"]
    assert tl.kernels(span="haar.detect")[0].name == "k1"
    gaps = tl.idle_gaps()
    assert gaps[0] == ("haar.detect/aten::nonzero", pytest.approx(40e-6))
    assert union_s(tl.kernels()) == pytest.approx(28e-6)
    assert tl.top_ops()[0] == ("k1", pytest.approx(18e-6))


def _kernel(name, ts, dur, correlation):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts - 2, 1, correlation=correlation),
            {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
             "args": {"correlation": correlation}}]


def test_the_step_readers_tell_the_fused_match_by_its_demangled_name():
    from types import SimpleNamespace

    from benchmark.harness import HERE, load_module

    # The names the profiler gives the kernels: demangled signatures, the
    # fused match's inside an anonymous namespace.
    gemm = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_execute_kernel__5x_cublas"
    products = ("void (anonymous namespace)::fused_match_products<true, 128>(CUtensorMap, "
                "float const*, float*, int, int, int)")
    finish = ("void (anonymous namespace)::fused_match_finish<8, false>(float*, float const*, "
              "float const*, float const*, int*, float*, int, int, int)")
    events = [_x("bench.window", "user_annotation", 0, 200)]
    for i, (name, ts, dur) in enumerate([(gemm, 10, 40), (products, 60, 12), (finish, 72, 6),
                                         (gemm, 110, 40), (products, 160, 12), (finish, 172, 6)]):
        events += _kernel(name, ts, dur, i)
    run = SimpleNamespace(timeline=Timeline(events), profiled_calls=2,
                          traffic={"streams": 512},
                          config={"template": 96, "components": 64, "gallery": 256})
    read = lambda name: load_module(HERE / "metrics" / f"{name}.py", "t_" + name.replace(".", "_")).read
    assert read("step_math.device_ms")(run) == pytest.approx(0.040)
    bound = roofline.fused_match(512, 96 * 96, 64, 256).seconds
    assert read("fused_match_roofline")(run) == pytest.approx(100.0 * bound / 18e-6)


@pytest.mark.parametrize("name, moves, reader", [
    ("step_math.device_ms.dispatch", "frames_per_s.dispatch", "step_math.device_ms"),
    ("device.idle_share.scan", "frames_per_s.scan", "device.idle_share"),
    ("step_math.device_ms", "frames_per_s", "step_math.device_ms"),
    ("haar.detect_ms", "frames_per_s.scan", "haar.detect_ms"),
    ("multistream.frames_per_s.dispatch", "latency_ms_p95.dispatch", "multistream.frames_per_s"),
])
def test_a_metric_split_off_with_its_end_to_end_metric_is_read_by_the_base_reader(name, moves,
                                                                                  reader):
    from benchmark.harness import HERE, reader_name

    assert reader_name({"name": name, "moves": moves}) == reader
    assert (HERE / "metrics" / f"{reader}.py").exists()


def test_every_per_layer_metric_has_a_reader():
    import json

    from benchmark.harness import HERE, ROOT, reader_name

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for metric in bench["per_layer"]:
        assert (HERE / "metrics" / f"{reader_name(metric)}.py").exists(), metric["name"]
