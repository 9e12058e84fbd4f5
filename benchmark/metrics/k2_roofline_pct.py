"""k2_roofline_pct.<cell>: K2's share of its roofline over the traced
window: the least time of each ``ops.bcount._bcount_call`` (``roofline/
k2.py``, b = W + 1 of the configuration, F = 2^S, the counts at their
returned width) over the device time, in the profiler's trace, of the
kernels the call launched (``trace.kernel_share``); nothing is read where
no call ran."""

from benchmark.roofline import k2, peaks
from benchmark.trace import kernel_share


def install(ctx):
    from niqki_tpu_torch.ops import bcount
    ctx.probes.wrap(bcount, "_bcount_call", "k2", tag=True,
                    info=lambda a, kw, out: (a[0].shape[1], a[1].shape[1],
                                             out.numel() * out.element_size()))


def read(ctx):
    p = ctx.config["params"]
    F, b = 1 << p["S"], p["W"] + 1
    return kernel_share(ctx, "k2", lambda i: peaks.least_seconds(
        *k2.work(i[0], i[1], F, b, i[2])))
