"""The program's own spans (``niqki_tpu_torch.debug``) in a traced
window, for the per-layer metrics whose source is ``program_span``.

``install(ctx)`` switches the program's tracing on before the window.
``taken(ctx)`` takes the recorded spans once a run, for every reader,
and switches tracing off again. A program without the tracer
(``debug.tracing``) records nothing: ``taken`` gives None, and every
reader built on it reads nothing.

Span times are ``time.perf_counter_ns()`` readings, the clock of
``ctx.window_t`` (``time.perf_counter()`` seconds); a span counts for
the part of it inside the window.
"""

from __future__ import annotations


def _tracer():
    from niqki_tpu_torch import debug
    if hasattr(debug, "tracing") and hasattr(debug, "spans"):
        return debug
    return None


def install(ctx) -> None:
    tracer = _tracer()
    if tracer is not None:
        tracer.tracing(True)


def taken(ctx):
    """The spans the program recorded in this run (None where it records
    none), taken from it at the first call."""
    if "program_spans" not in ctx.data:
        tracer = _tracer()
        got = None
        if tracer is not None:
            got = list(tracer.spans())
            tracer.tracing(False)
        ctx.data["program_spans"] = got
    return ctx.data["program_spans"]


def in_window(ctx):
    """(spans that overlap the window, window start ns, window end ns), or
    None where the window holds no span of the program."""
    got = taken(ctx)
    t0, t1 = (int(t * 1e9) for t in ctx.window_t)
    if not got or t1 <= t0:
        return None
    inside = [s for s in got if s.t1 > t0 and s.t0 < t1]
    return (inside, t0, t1) if inside else None


def seconds(spans, names, t0: int, t1: int, tid=None) -> float:
    """Seconds of the spans named in ``names`` (on thread ``tid`` where
    given) inside [t0, t1] ns."""
    return sum(max(0, min(s.t1, t1) - max(s.t0, t0)) for s in spans
               if s.name in names and (tid is None or s.tid == tid)) * 1e-9


def window_pct(ctx, name: str, tid=None):
    """The share of the window, in %, inside spans ``name``."""
    got = in_window(ctx)
    if got is None:
        return None
    spans, t0, t1 = got
    return 100.0 * seconds(spans, (name,), t0, t1, tid) / ((t1 - t0) * 1e-9)


def per_rebuild(ctx, names):
    """Seconds inside spans ``names`` per rebuild: over the window's
    ``engine.insert`` spans that open a request (one per rebuild); None
    where the window holds none."""
    got = in_window(ctx)
    if got is None:
        return None
    spans, t0, t1 = got
    n = sum(1 for s in spans if s.name == "engine.insert"
            and s.parent is None)
    return seconds(spans, names, t0, t1) / n if n else None
