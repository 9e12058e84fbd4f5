"""The spans and counts of ``engine.query_matrix`` (-M), on each route:
one ``engine.matrix`` request a call with its route and the sweep's
stats; ``sweep.emit`` counts (rows, survivors), ``sweep.mirror`` (entries
added, taken) on the calling thread, ``matrix.format`` (rows, bytes) on
the formatter threads and ``matrix.format_wait`` on the calling thread;
and output bytes equal with tracing on and off.

The index: 300 rows at lF=12 in 8 clusters that share half their slots,
-J 0.02 (min_score 81), blocks of 128 rows and windows quantized to 2
blocks, so the symmetric sweep has 3 blocks, mirrors and windows past
the index's end. A top-k cap of 16, under the clusters' ~37 survivors a
row, makes every sparse row overflow into the dense re-fetch.
"""

import gzip
import threading

import numpy as np
import pytest

from niqki_tpu_torch import SketchIndex, SketchParams, debug, engine
from niqki_tpu_torch import native
from niqki_tpu_torch.io.writers import GzTextWriter

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

G = 300
CASES = {                   # case: (route, environment)
    "sym": ("sym", {}),
    "sym-cap16": ("sym", {"NIQKI_TPU_MATRIX_CAP": "16"}),
    "full": ("full", {"NIQKI_TPU_MATRIX_SYM": "off"}),
    "dense": ("dense", {"NIQKI_TPU_MATRIX": "dense"}),
}


@pytest.fixture(autouse=True)
def tracing_off():
    debug.tracing(False)
    debug.spans()
    yield
    debug.tracing(False)
    debug.spans()


def _index():
    p = SketchParams(lF=12, K=21, min_fract=0.02)
    rng = np.random.default_rng(19)
    anc = rng.integers(0, 1 << p.W, (8, p.F), dtype=np.int32)
    mat = anc[np.arange(G) * 8 // G]
    mat = np.where(rng.random(mat.shape) < 0.5, mat,
                   rng.integers(0, 1 << p.W, mat.shape, dtype=np.int32))
    return SketchIndex.from_arrays(p, [f"g{i}" for i in range(G)],
                                   mat.astype(np.int32), device="cpu")


def _matrix(path) -> bytes:
    with GzTextWriter(str(path)) as out:
        engine.query_matrix(_index(), out)
    with gzip.open(path, "rb") as f:
        return f.read()


def _named(spans, name):
    return [s for s in spans if s.name == name]


@pytest.mark.parametrize("case", list(CASES))
def test_matrix_spans_count_what_the_call_wrote(case, monkeypatch,
                                                tmp_path):
    route, env = CASES[case]
    for k, v in {"NIQKI_TPU_MATRIX": "selfjoin",
                 "NIQKI_TPU_MATRIX_BLOCK": "128",
                 "NIQKI_TPU_MATRIX_QB": "2", **env}.items():
        monkeypatch.setenv(k, v)
    off = _matrix(tmp_path / "off.gz")
    assert len(debug.spans()) == 0
    debug.tracing(True)
    on = _matrix(tmp_path / "on.gz")
    spans = debug.spans()
    assert spans.dropped == 0
    assert on == off

    rows = on.split(b"\n")[1:-1]
    assert len(rows) == G
    written = sum(v != b"0" for r in rows for v in r.split(b"\t")[1:-1])
    assert written > G          # the diagonal and the clusters

    # the writer's close, after the call, opens a request of its own
    roots = [s for s in spans if s.parent is None
             and s.name != "writer.close"]
    assert [s.name for s in roots] == ["engine.matrix"]
    c = roots[0].counts
    assert c["G"] == G and c["route"] == route
    assert c["survivors"] == written
    emits = _named(spans, "sweep.emit")
    assert c.get("blocks", 0) == len(emits)
    assert sum(s.counts["rows"] for s in emits) == (G if emits else 0)
    if emits:
        assert sum(s.counts["survivors"] for s in emits) == written
    mirrors = _named(spans, "sweep.mirror")
    assert sum(s.counts["entries"] for s in mirrors) == \
        c.get("mirror_entries", 0)
    assert sum(s.counts["taken"] for s in mirrors) == \
        c.get("mirror_entries", 0)
    if route == "sym":
        assert c["blocks"] == 3 and c["window_cols"] == (3 + 2 + 2) * 128
        assert c["mirror_entries"] > 0 and c["peak_mirror_bytes"] > 0
        assert len(mirrors) == 3
    overflow = case.endswith("cap16")    # every row re-fetched dense
    if route == "sym":
        assert (c["refetch"] > 0) == overflow
    fmts = _named(spans, "matrix.format")
    assert sum(s.counts["rows"] for s in fmts) == G
    header = len(on.split(b"\n", 1)[0]) + 1
    assert sum(s.counts["bytes"] for s in fmts) == len(on) - header

    main = threading.get_native_id()
    assert all(s.tid == main for s in mirrors + emits
               + _named(spans, "matrix.format_wait"))
    if route != "dense" and not overflow:
        assert _named(spans, "matrix.format_wait")
        assert any(s.tid != main for s in fmts)
    by_id = {s.sid: s for s in spans}
    for s in spans:
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
        assert top is roots[0] or top.name == "writer.close", s.name
