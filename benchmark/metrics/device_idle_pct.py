"""device_idle_pct.<cell>: the share of the traced window in which no
operation ran on the device, 100 (1 - busy / window), from the
profiler's trace (``trace.reduce``). Missing launches in the trace make
it read high."""


def read(ctx):
    tr = ctx.trace_result
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
