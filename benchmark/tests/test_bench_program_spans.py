"""The readers of the program's spans (``program_spans.py`` and the
metrics built on it): synthetic spans against a window, spans that cross
its edges counted for their part inside, and nothing read where the
program records no span."""

import threading
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans

S = 1_000_000_000           # ns a second
MS = 1_000_000


def _span(name, a, b, tid=1, rid=1, parent=0):
    return SimpleNamespace(name=name, t0=int(a), t1=int(b), tid=tid,
                           rid=rid, parent=parent)


def _ctx(spans, t0=10.0, t1=20.0):
    return SimpleNamespace(data={"program_spans": spans}, window_t=(t0, t1))


def _read(metric, ctx):
    return harness.metric_module(metric).read(ctx)


def test_shares_of_the_window_count_the_part_inside():
    spans = [_span("engine.sketch_wait", 9 * S, 11 * S),      # 1 s inside
             _span("engine.sketch_wait", 12 * S, 14 * S),     # 2 s
             _span("engine.sketch_wait", 19 * S, 21 * S),     # 1 s
             _span("engine.sketch_wait", 21 * S, 22 * S),     # after
             _span("engine.query", 10 * S, 20 * S),
             _span("index.finalize", 15 * S, 16 * S, tid=2),
             _span("index.finalize", 16 * S, 16.5 * S, tid=3)]
    ctx = _ctx(spans)
    assert _read("sketch_wait_pct.query", ctx) == pytest.approx(40.0)
    assert _read("finalize_pct.query", ctx) == pytest.approx(15.0)


def test_emit_wait_counts_the_reading_thread_only():
    me = threading.get_native_id()
    spans = [_span("writer.wait", 10 * S, 11 * S, tid=me),
             _span("writer.wait", 19.5 * S, 25 * S, tid=me),
             _span("writer.wait", 12 * S, 18 * S, tid=me + 1)]
    assert _read("emit_wait_pct.query", _ctx(spans)) == pytest.approx(15.0)
    # the window holds spans, none of them the writer's: 0
    assert _read("emit_wait_pct.query", _ctx(spans[2:])) == 0.0


def test_encode_ms_is_the_median_request():
    spans = [_span("index.encode", 11 * S, 11 * S + 2 * MS, rid=1),
             _span("index.encode", 12 * S, 12 * S + 1 * MS, rid=1),
             _span("index.encode", 13 * S, 13 * S + 5 * MS, rid=2),
             _span("index.encode", 14 * S, 14 * S + 1 * MS, rid=3),
             # a request cut by the window's edge is not a whole request
             _span("index.encode", 20 * S - MS, 20 * S + MS, rid=4),
             _span("k1.collect", 15 * S, 16 * S, rid=3)]
    assert _read("encode_ms.lookup", _ctx(spans)) == pytest.approx(3.0)
    assert _read("encode_ms.lookup", _ctx(spans[4:])) is None


def test_per_rebuild_seconds():
    spans = [_span("engine.insert", 10 * S, 13 * S, rid=1, parent=None),
             _span("engine.insert", 14 * S, 18 * S, rid=2, parent=None),
             _span("engine.insert", 15 * S, 16 * S, rid=2, parent=7),
             _span("index.matrix", 13 * S, 14 * S, rid=3, parent=None),
             _span("index.stored", 14 * S, 14.5 * S, rid=4, parent=None),
             _span("index.matrix", 19.5 * S, 22 * S, rid=5, parent=None),
             _span("stream.wait", 9 * S, 10.5 * S, tid=1, rid=1),
             _span("stream.wait", 15 * S, 16 * S, tid=1, rid=2),
             _span("planes.build", 14.5 * S, 15 * S, rid=6, parent=None)]
    ctx = _ctx(spans)
    # two rebuilds: 1 + 0.5 + 0.5 s of copies, 0.5 + 1 s of waits
    assert _read("host_copies_s.ingest", ctx) == pytest.approx(1.0)
    assert _read("pool_wait_s.ingest", ctx) == pytest.approx(0.75)
    no_rebuild = _ctx([s for s in spans if s.name != "engine.insert"])
    assert _read("host_copies_s.ingest", no_rebuild) is None


@pytest.mark.parametrize("metric", [
    "sketch_wait_pct.query", "finalize_pct.query", "emit_wait_pct.query",
    "encode_ms.lookup", "host_copies_s.ingest", "pool_wait_s.ingest"])
def test_nothing_is_read_without_spans(metric):
    assert _read(metric, _ctx(None)) is None
    assert _read(metric, _ctx([])) is None
    outside = [_span("engine.sketch_wait", 1 * S, 2 * S),
               _span("engine.insert", 30 * S, 31 * S, parent=None)]
    assert _read(metric, _ctx(outside)) is None


def test_install_and_take_switch_the_programs_tracing():
    from niqki_tpu_torch import debug
    ctx = SimpleNamespace(data={}, window_t=(0.0, 1e9))
    try:
        program_spans.install(ctx)
        assert debug.span("x") is not debug.NULL
        with debug.span("index.read"):
            pass
        got = program_spans.taken(ctx)
        assert [s.name for s in got] == ["index.read"]
        assert debug.span("x") is debug.NULL
        assert program_spans.taken(ctx) is got      # once a run
    finally:
        debug.tracing(False)
        debug.spans()


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """A port whose ``debug`` has ``span`` but no ``tracing`` records no
    span: install does nothing and every reader reads nothing."""
    from niqki_tpu_torch import debug
    monkeypatch.delattr(debug, "tracing")
    ctx = SimpleNamespace(data={}, window_t=(0.0, 1e9))
    program_spans.install(ctx)
    assert program_spans.taken(ctx) is None
    for m in ("sketch_wait_pct.query", "encode_ms.lookup",
              "pool_wait_s.ingest"):
        mod = harness.metric_module(m)
        mod.install(ctx)
        assert mod.read(ctx) is None
