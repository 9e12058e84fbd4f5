"""sketch_pct.<cell>: the share of the window spent inside
``SketchIndex.sketch_files`` (the query side's read, device sketch and
finalize), on whichever thread calls it; the port calls it on a prefetch
thread while the main thread counts and formats."""

from benchmark.spans import within


def install(ctx):
    from niqki_tpu_torch.index import SketchIndex
    ctx.probes.wrap(SketchIndex, "sketch_files", "sketch_files")


def read(ctx):
    t0, t1 = ctx.window_t
    spans = ctx.probes.spans.get("sketch_files", [])
    if not spans or t1 <= t0:
        return None
    return 100.0 * within(spans, t0, t1) / (t1 - t0)
