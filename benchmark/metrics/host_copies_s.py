"""host_copies_s.<cell>: seconds a rebuild spends in the host copies
before the plane build: the row assembly of the index matrix and its
sanitized copy (the program's ``index.matrix`` and ``index.stored``
spans), over the window's rebuilds (its ``engine.insert`` requests)."""

from benchmark import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    return program_spans.per_rebuild(ctx, ("index.matrix", "index.stored"))
