"""finalize_pct.<cell>: the share of the window spent finalizing sketch
tables (min-merge and densify of each query file's tables on the host,
holding the interpreter lock; the program's ``index.finalize`` spans, on
the prefetch thread in ``-Q``)."""

from benchmark import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    return program_spans.window_pct(ctx, "index.finalize")
