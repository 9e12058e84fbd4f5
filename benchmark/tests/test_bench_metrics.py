"""The arithmetic of the metrics: rates over whole completed calls, the
percentiles over every request, the trace's busy time and idle gaps, and
the readers found by name."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import common, harness, spans, trace


def test_rate_is_over_whole_calls_and_all_their_time():
    t0 = 100.0
    # the window of 10 s started three calls; the third ends past it and
    # counts, over the time until it ended
    done = [(100.0, 103.0, 0), (103.0, 106.0, 1), (106.0, 111.0, 2)]
    assert common.rate(960, done, t0) == pytest.approx(3 * 960 / 11)
    assert common.rate(960, done[:1], t0) == pytest.approx(320.0)


def test_nearest_rank_percentiles():
    v = list(range(1, 101))
    assert common.p_rank(v, 95) == 95
    assert common.p_rank(v, 50) == 50
    assert common.p_rank(list(range(1, 21)), 95) == 19
    assert common.p_rank([7.0], 95) == 7.0
    assert common.p_rank(reversed(v), 100) == 100
    assert math.isnan(common.p_rank([], 95))


def test_closed_loop_starts_calls_only_inside_the_window():
    import time
    done, t0 = common.closed_loop(0.05, lambda i: time.sleep(0.02) or i)
    assert all(a - t0 < 0.05 for a, _, _ in done)
    assert done[-1][1] - t0 >= 0.05         # the last ran to its end
    assert [d[2] for d in done] == list(range(len(done)))


def _ev(name, a, b, cat="cpu_op"):
    return {"ph": "X", "name": name, "ts": a, "dur": b - a, "cat": cat}


def test_trace_busy_time_and_idle_gaps():
    events = [
        _ev(trace.WINDOW, 0, 1000, "user_annotation"),
        _ev("bench::SketchIndex.sketch_files", 0, 400, "user_annotation"),
        _ev("bench::SketchIndex.sketch_files", 0, 400,
            "gpu_user_annotation"),                 # no device operation
        _ev("aten::copy_", 450, 500),
        _ev("bcount_kernel", 100, 300, "kernel"),
        _ev("radix_sort", 250, 350, "kernel"),      # overlaps: union
        _ev("Memcpy DtoH", 600, 700, "gpu_memcpy"),
        _ev("outside", 2000, 2100, "kernel"),       # after the window
        {"ph": "i", "name": "marker", "ts": 10},
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(350e-6)
    ops = dict(r["device_ops"])
    assert ops == pytest.approx({"bcount_kernel": 200e-6,
                                 "radix_sort": 100e-6,
                                 "Memcpy DtoH": 100e-6})
    idle = dict(r["idle_gaps"])
    # [0,100) and [350,600) mid 475 under aten::copy_, [700,1000) nothing
    assert idle["SketchIndex.sketch_files"] == pytest.approx(100e-6)
    assert idle["aten::copy_"] == pytest.approx(250e-6)
    assert idle["host: outside any traced call"] == pytest.approx(300e-6)


def _launch(cid, ts, tid=1):
    return {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
            "ts": ts, "dur": 5, "pid": 0, "tid": tid,
            "args": {"correlation": cid}}


def _kernel(cid, a, b):
    return {"ph": "X", "name": "bcount_kernel", "cat": "kernel", "ts": a,
            "dur": b - a, "pid": 1, "tid": 7, "args": {"correlation": cid}}


def _tag(probe, call, a, b, tid=1):
    return {"ph": "X", "name": spans.tagged(probe, call),
            "cat": "user_annotation", "ts": a, "dur": b - a, "pid": 0,
            "tid": tid}


def test_kernels_of_numbered_calls():
    events = [
        _ev(trace.WINDOW, 0, 10000, "user_annotation"),
        _tag("k2", 0, 100, 200), _launch(1, 110), _kernel(1, 300, 1300),
        # call 1 launches two kernels; the trace lost the second
        _tag("k2", 1, 2000, 2100), _launch(2, 2010), _kernel(2, 2200, 3200),
        _launch(3, 2050),
        # a launch on another thread inside call 1's time is not its own
        _launch(4, 2060, tid=2), _kernel(4, 2300, 2400),
        _tag("k1", 0, 5000, 5100, tid=2), _launch(5, 5010, tid=2),
        _kernel(5, 5200, 5300), _launch(6, 5020, tid=2),
        _kernel(6, 5300, 5450),
        _launch(7, 6000),                           # outside any call
    ]
    r = trace.reduce(events)
    calls = r["calls"]
    assert [n for n, _ in r["idle_gaps"] if "#" in n] == []
    assert calls["k2"][0] == pytest.approx([1, 1, 1000e-6])
    assert calls["k2"][1] == pytest.approx([2, 1, 1000e-6])
    assert calls["k1"][0] == pytest.approx([2, 2, 250e-6])


def test_kernel_share_takes_the_whole_calls():
    ctx = SimpleNamespace(
        trace_result={"calls": {"k2": {0: [1, 1, 2e-3], 1: [2, 1, 1e-3],
                                       2: [1, 1, 2e-3]}}},
        probes=spans.Probes())
    ctx.probes.spans["k2"] = [spans.Span("k2", 0, 1, call=i, info=1e-3)
                              for i in range(3)]
    # calls 0 and 2 are whole: 2 ms of least time over 4 ms
    assert trace.kernel_share(ctx, "k2", lambda i: i) == pytest.approx(50.0)
    ctx.trace_result["calls"]["k2"] = {1: [2, 1, 1e-3]}
    assert trace.kernel_share(ctx, "k2", lambda i: i) is None


def test_numbered_probe_calls_share_one_count():
    a = SimpleNamespace(f=lambda x: x)
    b = SimpleNamespace(f=lambda x: -x)
    p = spans.Probes()
    p.wrap(a, "f", "k", tag=True)
    p.wrap(b, "f", "k", tag=True)
    a.f(1), b.f(1), a.f(2)
    assert [s.call for s in p.spans["k"]] == [0, 1, 2]
    p.restore()


def test_a_profile_of_the_cpu_reduces(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            torch.ones(1000).sum()
    r = trace.from_profiler(prof, str(tmp_path))
    assert r["busy_s"] == 0 and r["window_s"] > 0
    assert r["idle_gaps"] and not list(tmp_path.iterdir())


def test_spans_within_a_window():
    s = [spans.Span("a", 0.0, 2.0), spans.Span("b", 3.0, 5.0)]
    assert spans.within(s, 1.0, 4.0) == pytest.approx(2.0)


def test_probes_wrap_and_restore():
    mod = SimpleNamespace(f=lambda x: x + 1)
    p = spans.Probes()
    orig = mod.f
    p.wrap(mod, "f", "f", info=lambda a, kw, out: out)
    assert mod.f(2) == 3 and p.spans["f"][0].info == 3
    p.restore()
    assert mod.f is orig


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = harness.load_spec()
    for m in spec["per_layer"]:
        assert hasattr(harness.metric_module(m["name"]), "read")


def test_metric_readers_on_hand_made_readings():
    ctx = SimpleNamespace(trace_result={"busy_s": 2.0, "window_s": 8.0},
                          data={"latency_ms": [5.0, 1.0, 3.0]})
    assert harness.metric_module("device_idle_pct.query").read(ctx) == 75.0
    assert harness.metric_module("lookup_p50_ms.lookup").read(ctx) == 3.0
    ctx.probes = spans.Probes()
    ctx.window_t = (0.0, 10.0)
    ctx.probes.spans["sketch_files"] = [spans.Span("s", 1.0, 3.5)]
    assert harness.metric_module("sketch_pct.query").read(ctx) == 25.0
    ctx.probes.spans["planes"] = [spans.Span("p", 0, 4.0),
                                  spans.Span("p", 5, 11.0)]
    assert harness.metric_module("planes_s.ingest").read(ctx) == 5.0


def test_readers_find_nothing_and_say_so():
    ctx = SimpleNamespace(trace_result=None, data={},
                          probes=spans.Probes(), window_t=(0.0, 1.0),
                          config={"params": {"S": 12, "W": 12}})
    for name in ("device_idle_pct.query", "lookup_p50_ms.lookup",
                 "sketch_pct.query", "planes_s.ingest",
                 "k2_roofline_pct.query"):
        assert harness.metric_module(name).read(ctx) is None
