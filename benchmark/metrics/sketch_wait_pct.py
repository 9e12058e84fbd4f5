"""sketch_wait_pct.<cell>: the share of the window in which the calling
thread waits for the query sketches of the prefetch thread (the
program's ``engine.sketch_wait`` spans in ``engine.query_fof_whole``)."""

from benchmark import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    return program_spans.window_pct(ctx, "engine.sketch_wait")
