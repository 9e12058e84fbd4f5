"""pool_wait_s.<cell>: seconds a rebuild's reading thread waits for the
host sketcher's pool (the program's ``stream.wait`` spans), over the
window's rebuilds (its ``engine.insert`` requests)."""

from benchmark import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    return program_spans.per_rebuild(ctx, ("stream.wait",))
