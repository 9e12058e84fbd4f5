"""The port's spans (``niqki_tpu_torch.debug``): off by default and then
recording nothing; on, the spans of -I/-Q, -i, a single lookup and the
-M sweep, with their parents across pool threads, request ids, nesting
and counts; the buffer's cap; and the clock they share with
``torch.profiler``.
"""

import gzip
import json
import os
import threading

import numpy as np
import pytest
import torch

from niqki_tpu_torch import SketchIndex, SketchParams, cli, debug, engine
from niqki_tpu_torch import native
from niqki_tpu_torch.io.writers import GzTextWriter

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FOF = f"{FIXDIR}/fof_tiny.txt"
QUERIES = (f"{FIXDIR}/tiny2.fa", f"{FIXDIR}/multi.fa")


@pytest.fixture(autouse=True)
def tracing_off():
    debug.tracing(False)
    debug.spans()
    yield
    debug.tracing(False)
    debug.spans()


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _bases(path):
    with open(path) as f:
        return sum(len(ln.strip()) for ln in f if not ln.startswith(">"))


def _records(path):
    with open(path) as f:
        return sum(ln.startswith(">") for ln in f)


def _query(tmp_path, out: str) -> None:
    q = tmp_path / "q.txt"
    q.write_text("".join(p + "\n" for p in QUERIES))
    assert cli.main(["-I", FOF, "-Q", str(q), "-S", "12", "-K", "21", "-J",
                     "0.05", "--device", "cpu", "-O", str(out)]) == 0


def _check_tree(spans):
    """Parents exist, share the request, and hold their children; a span
    on a pool thread descends from a span of another thread."""
    by_id = {s.sid: s for s in spans}
    main = threading.get_native_id()
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent is None:
            assert s.tid == main, s.name
            continue
        p = by_id[s.parent]
        assert p.rid == s.rid, (s.name, p.name)
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s.name, p.name)
    for s in spans:
        if s.tid != main:
            top = s
            while by_id[top.parent].tid == s.tid:
                top = by_id[top.parent]
            assert by_id[top.parent].tid != s.tid, s.name


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_costs_one_test(tmp_path):
    """Off (the default): span() is the shared null context, which is
    false, so no count is computed; nothing is recorded, carry hands the
    function back; the -I/-Q bytes are those of a run with tracing on."""
    s = debug.span("engine.query")
    assert s is debug.NULL and not s
    with s as inner:
        inner.set(rows=1)

    def f():
        return 1
    assert debug.carry(f) is f
    _query(tmp_path, tmp_path / "off.gz")
    assert len(debug.spans()) == 0
    debug.tracing(True)
    _query(tmp_path, tmp_path / "on.gz")
    assert len(debug.spans()) > 0
    assert _gz(tmp_path / "on.gz") == _gz(tmp_path / "off.gz")
    assert b"tiny2.fa:1 " in _gz(tmp_path / "on.gz")


def test_query_spans(tmp_path):
    """-I/-Q: the insert and the query each open a request; the prefetch
    thread's spans name their parents across threads; each sketch_files
    reads its one window in one index.read on its own thread; the counts
    are the inputs'."""
    debug.tracing(True)
    _query(tmp_path, tmp_path / "o.gz")
    spans = debug.spans()
    assert spans.dropped == 0
    _check_tree(spans)
    names = {s.name for s in spans}
    assert {"engine.insert", "engine.query", "engine.sketch_wait",
            "index.sketch_files", "index.read", "k1.dispatch",
            "k1.collect", "index.finalize", "index.insert_rows",
            "writer.close", "writer.deflate"} <= names
    main = threading.get_native_id()
    ins, = _named(spans, "engine.insert")
    qry, = _named(spans, "engine.query")
    assert ins.parent is None and qry.parent is None and ins.rid != qry.rid
    assert ins.counts == {"records": 3}
    assert qry.counts == {"queries": 2, "chunks": 1}
    sk = {s.rid: s for s in _named(spans, "index.sketch_files")}
    assert sk[ins.rid].counts == {"files": 3, "records": 3, "batched": 3}
    assert sk[ins.rid].tid == main
    assert sk[qry.rid].counts == {"files": 2, "records": 3, "batched": 2}
    assert sk[qry.rid].tid != main           # the prefetch thread
    reads = _named(spans, "index.read")
    with open(FOF) as f:
        idx_files = [os.path.join(FIXDIR, ln.strip()) for ln in f
                     if ln.strip()]
    for rid, files in ((ins.rid, idx_files), (qry.rid, QUERIES)):
        read, = [r for r in reads if r.rid == rid]
        assert read.tid == sk[rid].tid and read.parent == sk[rid].sid
        assert read.counts == {
            "files": len(files), "records": sum(_records(p) for p in files),
            "bases": sum(_bases(p) for p in files),
            "threads": min(len(files), 8, os.cpu_count() or 1),
            "skipped": 0}
    fin, = [s for s in _named(spans, "index.finalize") if s.rid == qry.rid]
    assert fin.counts == {"files": 2, "records": 3, "merged": 1,
                          "threads": min(2, 8, os.cpu_count() or 1)}
    assert fin.tid == sk[qry.rid].tid and fin.parent == sk[qry.rid].sid
    rows, = _named(spans, "index.insert_rows")
    assert rows.counts == {"rows": 3} and rows.rid == ins.rid
    wait, = _named(spans, "engine.sketch_wait")
    assert wait.tid == main and wait.parent == qry.sid
    close, = _named(spans, "writer.close")
    deflate, = _named(spans, "writer.deflate")
    assert deflate.parent == close.sid and deflate.tid != main
    assert deflate.counts["bytes"] == len(_gz(tmp_path / "o.gz"))
    assert close.counts == {"members": 1}


def test_close_counts_its_members(tmp_path):
    """A 1.5 MB close (a -Q call's hits): its members count equals its
    writer.deflate spans, children of the close on the pool's threads,
    which hold every byte of the file."""
    data = (b"/q/a.fa /g/b.fa:0.51 /g/c.fa:0.0732 \n" * 40000)[:1_500_000]
    debug.tracing(True)
    with GzTextWriter(str(tmp_path / "w.gz")) as w:
        w.write(data)
    spans = debug.spans()
    close, = _named(spans, "writer.close")
    deflates = _named(spans, "writer.deflate")
    assert close.counts == {"members": len(deflates)}
    assert len(deflates) == -(-len(data) // GzTextWriter.PIECE)
    main = threading.get_native_id()
    assert all(d.parent == close.sid and d.tid != main for d in deflates)
    assert sum(d.counts["bytes"] for d in deflates) == len(data)
    assert _gz(tmp_path / "w.gz") == data


def test_lines_spans(tmp_path, monkeypatch):
    """-i: the stream's reads and waits on the calling thread, the host
    sketcher's tasks on its pool under the insert's request, the longer
    records through K1 and finalize; one index row per record."""
    rng = np.random.default_rng(3)
    lens = [200, 900, 300, 1500, 250, 700]
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n" + "".join(rng.choice(list("ACGT"), n))
                          + "\n" for i, n in enumerate(lens)))
    monkeypatch.setenv("NIQKI_TPU_HOST_READS", "600")
    idx = SketchIndex(SketchParams(lF=10, K=21), device="cpu")
    debug.tracing(True)
    engine.insert_file_lines(idx, str(fa))
    spans = debug.spans()
    _check_tree(spans)
    main = threading.get_native_id()
    ins, = _named(spans, "engine.insert")
    assert ins.counts == {"records": len(lens)}
    assert all(s.rid == ins.rid for s in spans)
    reads = _named(spans, "stream.read")
    assert sum(s.counts["records"] for s in reads) == len(lens)
    assert sum(s.counts["bases"] for s in reads) == sum(lens)
    assert all(s.tid == main for s in reads)
    host = _named(spans, "stream.host_sketch")
    assert sum(s.counts["records"] for s in host) == 3
    assert all(s.tid != main and s.parent == ins.sid for s in host)
    assert _named(spans, "stream.wait")
    fin = _named(spans, "index.finalize")
    assert sum(s.counts["files"] for s in fin) == 3
    assert sum(s.counts["records"] for s in fin) == 3
    assert all(s.counts["merged"] == 0 and s.tid == main for s in fin)
    assert _named(spans, "k1.dispatch") and _named(spans, "k1.collect")
    assert sum(s.counts["rows"]
               for s in _named(spans, "index.insert_rows")) == len(lens)
    assert idx.G == len(lens)


def _lookup_index():
    p = SketchParams(lF=12, K=21, min_fract=0.001)
    rng = np.random.default_rng(11)
    mat = rng.integers(0, 1 << p.W, (4096, p.F), dtype=np.int32)
    return SketchIndex.from_arrays(p, [f"g{i}" for i in range(4096)], mat,
                                   device="cpu")


def test_lookup_spans_and_the_cap(monkeypatch):
    """One sketch_file and pretty_hits_batch: sketch_files' window of one
    file (the native read, K1, finalize), the host copy and plane build,
    K2 and the formatter, each with its counts; a cap of 3 keeps three
    spans and counts the rest dropped."""
    idx = _lookup_index()
    path = QUERIES[0]
    debug.tracing(True)
    q = idx.sketch_file(path)
    buf = idx.pretty_hits_batch(q[None], [path])
    spans = debug.spans()
    _check_tree(spans)
    assert buf.startswith(path.encode() + b" ")
    sk, = _named(spans, "index.sketch_files")
    assert sk.counts == {"files": 1, "batched": 1, "records": 1}
    read, = _named(spans, "index.read")
    assert read.counts == {"files": 1, "records": 1, "bases": _bases(path),
                           "threads": 1, "skipped": 0}
    fin, = _named(spans, "index.finalize")
    assert fin.counts == {"files": 1, "records": 1, "merged": 0,
                          "threads": 1}
    col, = _named(spans, "k1.collect")
    assert col.counts["bytes"] >= idx.params.F * 2
    dis, = _named(spans, "k1.dispatch")
    assert all(s.parent == sk.sid for s in (read, dis, col, fin))
    assert not _named(spans, "index.encode")
    stored, = _named(spans, "index.stored")
    assert stored.counts == {"bytes": 4096 * idx.params.F * 4}
    planes, = _named(spans, "planes.build")
    assert planes.counts == {"bytes": 4096 * idx.params.F * 2}
    k2, = _named(spans, "k2.count")
    assert k2.counts == {"Q": 1, "G": 4096, "lanes": idx.params.F // 32}
    fmt, = _named(spans, "emit.format")
    assert fmt.counts == {"rows": 1, "bytes": len(buf)}
    assert len(spans) == 9
    monkeypatch.setattr(debug, "CAP", 3)
    q = idx.sketch_file(path)
    idx.pretty_hits_batch(q[None], [path])
    got = debug.spans()     # the copy and the planes are cached: 7 spans
    assert [s.name for s in got] == ["index.read", "k1.dispatch",
                                     "k1.collect"]
    assert got.dropped == 4


def test_spans_share_the_profilers_clock(tmp_path):
    """Under a CPU torch.profiler run on this thread, each span of this
    thread is also a profiler range, and its start converted to the
    trace's clock lies within 1 ms of that range's; a pool thread's spans
    are not (the profiler does not record that thread), and merge adds
    them once each."""
    idx = _lookup_index()
    idx._planes()
    debug.tracing(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for path in QUERIES:
            q = idx.sketch_file(path)
            idx.pretty_hits_batch(q[None], [path])
        idx.sketch_files(QUERIES)
        # 1 MB: the close's members deflate on the writer's pool
        with GzTextWriter(str(tmp_path / "w.gz")) as w:
            w.write(b"ACGT\n" * 200_000)
    spans = debug.spans()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    main = threading.get_native_id()
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("tid") == main:
            ranges.setdefault(e["name"], []).append(e["ts"])
    mine = [s for s in spans if s.tid == main]
    assert len(mine) >= 10 and all(s.profiled for s in mine)
    for s in mine:
        ts = (debug.unix_ns(s.t0) - base) / 1000.0
        assert min(abs(ts - r) for r in ranges[s.name]) < 1000.0, s.name
    others = [s for s in spans if s.tid != main]
    assert others and not any(s.profiled for s in others)
    debug.merge(path, spans)
    with open(path) as f:
        merged = json.load(f)["traceEvents"]
    added = [e for e in merged if e.get("ph") == "X"
             and "request" in (e.get("args") or {})]
    assert len(added) == len(others)
    assert {e["tid"] for e in added} == {s.tid for s in others}


def test_matrix_sweep_spans(monkeypatch, tmp_path):
    """-M's symmetric sweep: one sweep.dispatch, sweep.wait and sweep.emit
    span per block, in the calling thread's order."""
    p = SketchParams(lF=12, K=21, min_fract=0.02)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 1 << p.W, (8, p.F), dtype=np.int32)
    mat = base[rng.integers(0, 8, 300)]
    mat = np.where(rng.random(mat.shape) < 0.5, mat,
                   rng.integers(0, 1 << p.W, mat.shape, dtype=np.int32))
    idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(300)],
                                  mat.astype(np.int32), device="cpu")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_BLOCK", "128")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_QB", "2")
    debug.tracing(True)
    with GzTextWriter(str(tmp_path / "m.gz")) as out:
        stats = engine._query_matrix_selfjoin_sym(idx, out)
    spans = debug.spans()
    _check_tree(spans)
    n = stats["N"]
    assert n == 3
    main = threading.get_native_id()
    sweep = [s for s in spans
             if s.name in ("sweep.dispatch", "sweep.wait", "sweep.emit")]
    assert all(s.tid == main for s in sweep)
    order = [(s.name, s.counts["block"])
             for s in sorted(sweep, key=lambda s: s.t0)]
    assert order == [("sweep.dispatch", 0), ("sweep.dispatch", 1),
                     ("sweep.wait", 0), ("sweep.dispatch", 2),
                     ("sweep.emit", 0), ("sweep.wait", 1), ("sweep.emit", 1),
                     ("sweep.wait", 2), ("sweep.emit", 2)]


def test_the_buffer_counts_every_span_across_threads(monkeypatch):
    """More threads than cores, switching often: every span is kept or
    counted as dropped, and the buffer holds exactly its cap."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    n_threads, each, cap = 4 * (os.cpu_count() or 1), 500, 1000
    monkeypatch.setattr(debug, "CAP", cap)
    debug.tracing(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(_):
            for _ in range(each):
                with debug.span("stress"):
                    pass
        with ThreadPoolExecutor(n_threads) as ex:
            list(ex.map(work, range(n_threads), timeout=120))
    finally:
        sys.setswitchinterval(old)
    got = debug.spans()
    assert len(got) == cap
    assert len(got) + got.dropped == n_threads * each
