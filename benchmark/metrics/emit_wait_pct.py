"""emit_wait_pct.<cell>: the share of the window in which the calling
thread waits for the output writer's deflate pool (the program's
``writer.wait`` spans on the thread that runs the loop, which is the
thread that reads the metric)."""

import threading

from benchmark import program_spans


def install(ctx):
    program_spans.install(ctx)


def read(ctx):
    return program_spans.window_pct(ctx, "writer.wait",
                                    tid=threading.get_native_id())
