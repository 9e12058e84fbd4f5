"""Index rebuilds (``-i``): a closed loop in which each rebuild ingests the
whole multi-FASTA into a fresh ``SketchIndex`` through
``engine.insert_file_lines`` and answers its first query (the plane build,
then ``pretty_hits_batch`` of one query file's sketch), ending in
``torch.cuda.synchronize()``.

End-to-end: ``ingest_mbp_per_s``, the input bases of every rebuild the
window started (the last runs to its end) over the time from the window's
start until the last rebuild ended.

Check: every rebuild holds every genome, under its header, and answers
with the same bytes for the same query; for up to ``check_rebuilds``
rebuilds drawn from the seed among the window's,
``check_index_rows`` index sketches drawn from the seed equal the plain
reference's, and the first answer equals the reference's row.
"""

from __future__ import annotations

import numpy as np

from .. import common
from ..harness import Check


def _inputs(ctx) -> None:
    common.make_index_inputs(ctx)
    common.make_query_pool(ctx, ctx.traffic["pool"])
    g = ctx.data["genomes"]
    ctx.data["rows"] = np.sort(np.asarray(common.sample(
        ctx.seed, range(g.G), ctx.traffic["check_index_rows"])))


def setup(ctx) -> None:
    _inputs(ctx)
    common.reset_peak(ctx)
    _rebuild(ctx, 0)                    # warm-up: one whole rebuild


def _rebuild(ctx, i: int):
    """One rebuild and its first answer; keeps what the check reads (the
    index's names, a sample of its rows, the answer) and frees the rest
    before the next rebuild starts."""
    paths = ctx.data["query_paths"]
    q = i % len(paths)
    idx = common.build_index(ctx)
    buf = idx.pretty_hits_batch(idx.sketch_file(paths[q])[None], [paths[q]])
    common.sync(ctx)
    return q, buf, idx


def window(ctx, seconds: float) -> dict:
    kept = []

    def call(i):
        q, buf, idx = _rebuild(ctx, i)
        whole = idx.names == ctx.data["index_names"]
        kept.append((q, buf, whole,
                     idx.matrix()[ctx.data["rows"]].copy() if whole
                     else None))
        del idx
        return len(kept) - 1

    done, t0 = common.closed_loop(seconds, call)
    ctx.data["done"], ctx.data["t0"], ctx.data["kept"] = done, t0, kept
    ctx.attempted = len(done)
    bases = ctx.data["bases"]
    return {"ingest_mbp_per_s": common.rate(bases / 1e6, done, t0)}


def control(ctx, bits: int) -> None:
    """``check_rebuilds`` rebuilds by the reference: its index rows and
    its first answers."""
    _inputs(ctx)
    n = ctx.traffic["check_rebuilds"]
    paths = ctx.data["query_paths"]
    qs = [i % len(paths) for i in range(n)]
    rows = common.index_sketches(ctx, bits)[ctx.data["rows"]]
    rows = rows.cpu().numpy().astype(np.int32)
    answers = common.hit_rows(ctx, qs, [paths[q] for q in qs], bits)
    ctx.data["kept"] = [(q, a.encode(), True, rows)
                        for q, a in zip(qs, answers)]
    ctx.data["done"] = [(0.0, 0.0, k) for k in range(n)]


def judge(ctx) -> list:
    t = ctx.traffic
    paths = ctx.data["query_paths"]
    kept = ctx.data["kept"]
    done = ctx.data["done"]
    bad = sum(int(not names_ok or not isinstance(buf, bytes))
              for _, buf, names_ok, _ in kept)
    seen = {}
    differ = sum(int(seen.setdefault(q, buf) != buf)
                 for q, buf, _, _ in kept)
    picks = [done[k][2] for k in common.sample(ctx.seed, range(len(done)),
                                               t["check_rebuilds"])]
    x = common.index_sketches(ctx)
    want_rows = x[ctx.data["rows"]].cpu().numpy().astype(np.int32)
    rows_wrong = sum(len(want_rows) if kept[k][3] is None
                     else int((kept[k][3] != want_rows).any(axis=1).sum())
                     for k in picks)
    qs = [kept[k][0] for k in picks]
    want = common.hit_rows(ctx, qs, [paths[q] for q in qs])
    wrong = sum(int(kept[k][1] != w.encode()) for k, w in zip(picks, want))
    ctx.failed = bad
    return [Check("rebuilds_incomplete", bad, 0),
            Check("repeat_answers_differing", differ, 0),
            Check("sampled_index_rows_wrong", rows_wrong, 0),
            Check("first_answers_wrong", wrong, 0)]
