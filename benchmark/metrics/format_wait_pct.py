"""format_wait_pct.<cell>: the share of the window in which the calling
thread waits for the -M matrix formatter's threads to hand back a
block's text (the program's ``matrix.format_wait`` spans; the write of
the text that follows is not in them). Nothing is read where the program
records no such span."""

import threading

from benchmark import program_spans

NAME = "matrix.format_wait"


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    got = program_spans.in_window(ctx)
    if got is None or not any(s.name == NAME for s in got[0]):
        return None
    return program_spans.window_pct(ctx, NAME,
                                    tid=threading.get_native_id())
