"""The reader of ``ncc_roofline`` on synthetic timelines: the tracker's NCC
kernel's bound at the cells' shapes, its share over the time its launches
cover, told by its demangled name; nothing where the program launched no
such kernel."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import HERE, load_module, reader_name
from benchmark.timeline import Timeline

NCC = "void (anonymous namespace)::ncc_locate_kernel((anonymous namespace)::Params)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_execute_kernel__5x_cublas"


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def _launched(name, ts, dur, corr):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts - 2, 1, correlation=corr),
            {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
             "args": {"correlation": corr}}]


def tracker_calls(locate):
    """Two profiled tracker steps: a window gather, the locate kernels
    named (each 200 us), a crop gather and the fused match."""
    events = [_x("bench.window", "user_annotation", 0, 2000)]
    corr = 0
    for t in (0, 1000):
        steps = [("index_elementwise_kernel", 10, 50)]
        steps += [(name, 100 + 250 * i, 200) for i, name in enumerate(locate)]
        steps += [("index_elementwise_kernel", 800, 20), ("fused_match_products", 850, 20)]
        for name, ts, dur in steps:
            corr += 1
            events += _launched(name, t + ts, dur, corr)
    return events


def reader():
    return load_module(HERE / "metrics" / "ncc_roofline.py", "t_ncc_roofline")


def _run(events, streams):
    return SimpleNamespace(timeline=Timeline(events), profiled_calls=2,
                           traffic={"streams": streams},
                           config={"window": 192, "template": 96})


@pytest.mark.parametrize("streams, micros, mflop", [(512, 22.583, 1631.4), (64, 2.862, 203.9)])
def test_the_bound_at_the_cells_is_the_windows_bytes(streams, micros, mflop):
    b = reader().bound(streams, 192, 96)
    assert b.by == "bytes"
    assert b.seconds * 1e6 == pytest.approx(micros, abs=0.001)
    assert b.flops / 1e6 == pytest.approx(mflop, abs=0.1)


def test_the_share_is_read_over_the_kernels_time_by_their_name():
    run = _run(tracker_calls([NCC]), 512)
    want = 100.0 * reader().bound(512, 192, 96).seconds / 200e-6
    assert reader().read(run) == pytest.approx(want)
    assert 0 < reader().read(run) < 100
    # The parent's plain route: DFT GEMMs and elementwise kernels, no locate kernel.
    assert reader().read(_run(tracker_calls([GEMM, "elementwise_kernel"]), 512)) is None
    assert reader().read(SimpleNamespace(timeline=None, profiled_calls=0)) is None


def test_the_metric_is_declared_for_both_tracker_cells_with_its_reader():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    for name, moves, cell in [("ncc_roofline", "frames_per_s", "tracker-1080p.s512"),
                              ("ncc_roofline.dispatch", "latency_ms_p95.dispatch",
                               "tracker-1080p.s64")]:
        metric = by_name[name]
        assert metric["moves"] == moves and metric["unit"] == "%"
        assert metric["workloads"] == [cell] and cells[cell] == "tracker-1080p"
        assert reader_name(metric) == "ncc_roofline"
