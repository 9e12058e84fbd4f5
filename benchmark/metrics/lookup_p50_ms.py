"""lookup_p50_ms.<cell>: the median (nearest rank) of the host-clock
latencies of the requests completed in the window."""

from benchmark.common import p_rank


def read(ctx):
    ms = ctx.data.get("latency_ms")
    return p_rank(ms, 50) if ms else None
