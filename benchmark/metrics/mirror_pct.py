"""mirror_pct.<cell>: the share of the window in which the calling thread
assembles the symmetric -M sweep's rows from its mirrors (the program's
``sweep.mirror`` spans: a block's pending mirror entries taken, its
survivors' mirrors added, their sort and scatter into the rows'
buffers). Nothing is read where the program records no such span."""

import threading

from benchmark import program_spans

NAME = "sweep.mirror"


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    got = program_spans.in_window(ctx)
    if got is None or not any(s.name == NAME for s in got[0]):
        return None
    return program_spans.window_pct(ctx, NAME,
                                    tid=threading.get_native_id())
