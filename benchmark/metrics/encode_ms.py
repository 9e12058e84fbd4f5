"""encode_ms.<cell>: the median (nearest rank) over the window's
requests of the milliseconds spent reading a query file's records and
encoding and packing them (the program's ``index.encode`` spans, summed
per request id)."""

from benchmark import program_spans
from benchmark.common import p_rank


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    got = program_spans.in_window(ctx)
    if got is None:
        return None
    spans, t0, t1 = got
    per = {}
    for s in spans:
        if s.name == "index.encode" and t0 <= s.t0 and s.t1 <= t1:
            per[s.rid] = per.get(s.rid, 0) + (s.t1 - s.t0)
    return p_rank([v * 1e-6 for v in per.values()], 50) if per else None
