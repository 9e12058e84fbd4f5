"""Single-genome lookups: one caller in a closed loop, each request one
query file of a pool of ``pool``, through ``SketchIndex.sketch_file(path)``
and ``SketchIndex.pretty_hits_batch(q[None], [path])``, whose answer is the
request's hit row.

End-to-end: ``lookup_p95_ms``, the 95th percentile (nearest rank) of the
host-clock latencies of every request the window started (the last
runs to its end).

A traced run reads a window of ``trace_seconds`` at most: the profiler's
own reading of many small requests is slow.

Check: every answer is a row for its query, and requests for one query
answer with the same bytes; ``check_rows`` answers drawn from the seed
among the window's requests equal, byte for byte, the rows
the plain reference makes from the same genomes.
"""

from __future__ import annotations

from .. import common
from ..harness import Check


def _inputs(ctx) -> None:
    common.make_index_inputs(ctx)
    common.make_query_pool(ctx, ctx.traffic["pool"])


def setup(ctx) -> None:
    _inputs(ctx)
    common.reset_peak(ctx)
    ctx.state["index"] = common.build_index(ctx)
    for i in range(ctx.traffic["warmup_requests"]):
        _request(ctx, i)


def _request(ctx, i: int):
    idx = ctx.state["index"]
    paths = ctx.data["query_paths"]
    path = paths[i % len(paths)]
    q = idx.sketch_file(path)
    return i % len(paths), idx.pretty_hits_batch(q[None], [path])


def window(ctx, seconds: float) -> dict:
    done, t0 = common.closed_loop(seconds, lambda i: _request(ctx, i))
    ctx.data["done"], ctx.data["t0"] = done, t0
    ctx.attempted = len(done)
    ms = [(b - a) * 1e3 for a, b, _ in done]
    ctx.data["latency_ms"] = ms
    return {"lookup_p95_ms": common.p_rank(ms, 95)}


def control(ctx, bits: int) -> None:
    """``check_rows`` requests, one a pool query, answered by the
    reference."""
    _inputs(ctx)
    n = ctx.traffic["check_rows"]
    paths = ctx.data["query_paths"][:n]
    rows = common.hit_rows(ctx, list(range(n)), paths, bits)
    ctx.data["done"] = [(0.0, 0.0, (q, r.encode()))
                        for q, r in enumerate(rows)]


def judge(ctx) -> list:
    t = ctx.traffic
    paths = ctx.data["query_paths"]
    done = ctx.data["done"]
    bad = differ = 0
    seen = {}
    for _, _, (q, buf) in done:
        ok = isinstance(buf, bytes) and buf.count(b"\n") == 1 \
            and buf.startswith(paths[q].encode() + b" ")
        bad += int(not ok)
        differ += int(seen.setdefault(q, buf) != buf)
    picked = common.sample(ctx.seed, range(len(done)), t["check_rows"])
    qs = [done[k][2][0] for k in picked]
    want = common.hit_rows(ctx, qs, [paths[q] for q in qs])
    wrong = sum(1 for k, w in zip(picked, want)
                if done[k][2][1] != w.encode())
    ctx.failed = bad
    return [Check("answers_missing_or_malformed", bad, 0),
            Check("repeat_answers_differing", differ, 0),
            Check("sampled_answers_wrong", wrong, 0),
            Check("sampled_answers_checked_short",
                  max(0, t["check_rows"] - len(picked)), 0)]
