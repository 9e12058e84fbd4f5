"""Batched whole-genome queries (``-Q``): a closed loop of
``engine.query_fof_whole(index, fof, out)`` calls, each over a
file-of-files of ``queries_per_call`` query genomes, cycling through a pool
of ``pool`` distinct query files. Each call writes its rows through the
port's own gzip writer into an in-memory sink.

End-to-end: ``query_genomes_per_s``, the query genomes of every call the
window started (the last runs to its end) over the time from the window's
start until the last call ended.

Check: every call's output holds one row per query, in fof order, and
calls over one fof write the same bytes; ``check_rows`` rows drawn from
the seed among the window's calls (at most ``check_calls`` of them) equal, byte for byte, the rows the plain reference makes from
the same genomes.
"""

from __future__ import annotations

import os

from .. import common
from ..harness import Check


def _inputs(ctx) -> None:
    t = ctx.traffic
    common.make_index_inputs(ctx)
    paths = common.make_query_pool(ctx, t["pool"])
    per = t["queries_per_call"]
    fofs = []
    for k in range(0, len(paths), per):
        fof = os.path.join(ctx.tmp, f"fof{k // per}.txt")
        if ctx.write:
            with open(fof, "w") as f:
                f.write("".join(p + "\n" for p in paths[k:k + per]))
        fofs.append((fof, k))
    ctx.data["fofs"] = fofs


def setup(ctx) -> None:
    _inputs(ctx)
    common.reset_peak(ctx)
    ctx.state["index"] = common.build_index(ctx)
    _call(ctx, 0)                       # warm-up: every shape of a call


def _call(ctx, i: int):
    from niqki_tpu_torch import engine
    fof, first = ctx.data["fofs"][i % len(ctx.data["fofs"])]
    w, sink = common.sink_writer()
    engine.query_fof_whole(ctx.state["index"], fof, w)
    w.close()
    return first, sink


def window(ctx, seconds: float) -> dict:
    done, t0 = common.closed_loop(seconds, lambda i: _call(ctx, i))
    ctx.data["done"], ctx.data["t0"] = done, t0
    per = ctx.traffic["queries_per_call"]
    ctx.attempted = len(done) * per
    return {"query_genomes_per_s": common.rate(per, done, t0)}


def control(ctx, bits: int) -> None:
    """The first fof's call, its rows made by the reference."""
    _inputs(ctx)
    per = ctx.traffic["queries_per_call"]
    paths = ctx.data["query_paths"][:per]
    rows = common.hit_rows(ctx, list(range(per)), paths, bits)
    ctx.data["done"] = [(0.0, 0.0, (0, common.Sink.of(
        "".join(rows).encode())))]


def judge(ctx) -> list:
    t = ctx.traffic
    per = t["queries_per_call"]
    paths = ctx.data["query_paths"]
    done = ctx.data["done"]
    calls = common.sample(ctx.seed, range(len(done)), t["check_calls"])
    short = differ = 0
    picked = []     # (pool index, row bytes)
    texts, digests = {}, {}
    for ci, (_, _, (first, sink)) in enumerate(ctx.data["done"]):
        differ += int(digests.setdefault(first, sink.digest())
                      != sink.digest())
        rows = common.split_rows(sink.text())
        want = paths[first:first + per]
        short += sum(1 for k, p in enumerate(want)
                     if k >= len(rows)
                     or not rows[k].startswith(p.encode() + b" "))
        short += max(0, len(rows) - len(want))
        if ci in calls:
            texts[ci] = (first, rows)
    per_call = -(-t["check_rows"] // len(texts))
    for ci in sorted(texts):
        first, rows = texts[ci]
        for k in common.sample(ctx.seed + ci, range(min(per, len(rows))),
                               per_call):
            picked.append((first + k, rows[k]))
    want = common.hit_rows(ctx, [q for q, _ in picked],
                           [paths[q] for q, _ in picked])
    wrong = sum(1 for (_, got), w in zip(picked, want) if got != w.encode())
    ctx.failed = short
    return [Check("rows_missing_or_misplaced", short, 0),
            Check("repeat_calls_differing", differ, 0),
            Check("sampled_rows_wrong", wrong, 0),
            Check("sampled_rows_checked_short", max(0, t["check_rows"]
                                                    - len(picked)), 0)]
