"""Debug logging, the port's spans and the profiler hook.

The counterpart of ``niqki_tpu/debug.py``. The reference's compile-time
DEBUG_MSG macros become a runtime switch:

    NIQKI_TPU_DEBUG=1   engine-level log (files, batches, each span's time)
    NIQKI_TPU_DEBUG=2   + per-file, per-batch and per-record detail

Spans. ``span(name)`` marks a host region of one of the port's layers
(``engine.query``, ``index.read``, ``k2.count``, ...). It does nothing
unless tracing is on (``tracing(True)``) or the debug level is at least
the span's: then the shared ``NULL`` context comes back, with no clock
read, allocation or torch call. ``NULL`` is false, so a region computes
its counts only under ``if s:`` and sets them with ``s.set(**counts)``.
With tracing on, a span records its name, its thread
(``threading.get_native_id()``), its start and end
(``time.perf_counter_ns()``), its parent span (the innermost open span
of its thread, or the span that handed the task to this thread through
``carry``), a request id and its counts (rows, files, records, bytes).
A span without a parent opens a request: every span under it, on any
thread, shares its id. Records go to one buffer of at most ``CAP`` spans; later
spans are counted as dropped. ``spans()`` takes them and clears the
buffer. At a debug level of at least the span's, a span also logs its
duration on standard error.

While a torch profiler records the span's own thread, the span also
enters ``torch.profiler.record_function(name)``, so the profiler's
timeline names it. ``profile(trace_dir, device)`` wraps a region in
``torch.profiler`` (host activity always, the card's kernels and copies
where the device is ``cuda``), switches tracing on for it, and writes one
Chrome/TensorBoard ``*.pt.trace.json`` into ``trace_dir`` holding every
span of the region once, each on its own thread's track, on the
profiler's clock (``merge``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import sys
import threading
import time

LEVEL = int(os.environ.get("NIQKI_TPU_DEBUG", "0") or "0")
CAP = 1 << 18           # spans the buffer holds until ``spans()`` takes them

_ON = False
_BUF: list = []
_DROPPED = 0
_LOCK = threading.Lock()   # the buffer and the drop count, across threads
_IDS = itertools.count(1)
_RIDS = itertools.count(1)
_LOCAL = threading.local()
_ANCHOR = (0, 0)        # (perf_counter_ns, time_ns) read together
_THREADS: dict = {}     # native thread id -> thread name, of span threads
_PROFILING = None       # the profiler's "records this thread" test
_RANGE = None           # torch.profiler.record_function


def dbg(msg: str, level: int = 1) -> None:
    if LEVEL >= level:
        print(f"[niqki_tpu +{time.monotonic():.3f}] {msg}",
              file=sys.stderr, flush=True)


class _Null:
    """The span of a region that nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **counts) -> None:
        pass


NULL = _Null()


class Span:
    """One span: open as a context, then a record of the buffer. ``t0``
    and ``t1`` are ``time.perf_counter_ns()`` readings; ``profiled`` is
    true where the profiler's timeline holds the span already."""
    __slots__ = ("name", "level", "counts", "tid", "sid", "parent", "rid",
                 "t0", "t1", "profiled", "_range")

    def __init__(self, name: str, level: int):
        self.name = name
        self.level = level
        self.counts = {}
        self.profiled = False
        self._range = None

    def set(self, **counts) -> None:
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def __enter__(self):
        loc = _LOCAL
        try:
            stack = loc.stack
        except AttributeError:
            stack = _thread_state().stack
        if stack:
            self.parent, self.rid = stack[-1].sid, stack[-1].rid
        elif loc.carried is not None:
            self.parent, self.rid = loc.carried
        else:
            self.parent, self.rid = None, next(_RIDS)
        self.sid = next(_IDS)
        self.tid = loc.tid
        stack.append(self)
        if _ON and _PROFILING is not None and _PROFILING():
            # the profiler stamps the range inside the call: the middle
            # of the call is the span's start on both clocks
            a = time.perf_counter_ns()
            self._range = _RANGE(self.name)
            self._range.__enter__()
            self.profiled = True
            self.t0 = (a + time.perf_counter_ns()) // 2
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            a = time.perf_counter_ns()
            self._range.__exit__(None, None, None)
            self._range = None
            self.t1 = (a + time.perf_counter_ns()) // 2
        else:
            self.t1 = time.perf_counter_ns()
        stack = _LOCAL.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if _ON:
            _keep(self)
        if LEVEL >= self.level:
            more = "".join(f" {k}={v}" for k, v in self.counts.items())
            dbg(f"{self.name}: {self.seconds:.4f}s{more}", self.level)
        return False


def _thread_state():
    """This thread's open spans, carried parent and native id, set up at
    its first span."""
    loc = _LOCAL
    if not hasattr(loc, "stack"):
        loc.stack, loc.carried = [], None
        loc.tid = threading.get_native_id()
        _THREADS[loc.tid] = threading.current_thread().name
    return loc


def _keep(s: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_BUF) < CAP:
            _BUF.append(s)
        else:
            _DROPPED += 1


def span(name: str, level: int = 1):
    """The span of one region (a context; ``as s`` gives ``s.set(**counts)``,
    and ``s`` is false where nothing records it). ``level``: the debug
    level at which it logs."""
    if not _ON and LEVEL < level:
        return NULL
    return Span(name, level)


def carry(fn):
    """``fn`` as a pool task whose spans name the submitting thread's open
    span as their parent and share its request; ``fn`` itself where
    tracing is off or no span is open."""
    if not _ON:
        return fn
    stack = getattr(_LOCAL, "stack", None)
    if not stack:
        return fn
    link = (stack[-1].sid, stack[-1].rid)

    def task(*args, **kwargs):
        loc = _thread_state()
        prev, loc.carried = loc.carried, link
        try:
            return fn(*args, **kwargs)
        finally:
            loc.carried = prev
    return task


class Spans(list):
    """The spans ``spans()`` took, in the order they ended; ``dropped``
    counts those the full buffer left out."""
    dropped = 0


def tracing(on: bool = True) -> None:
    """Switch span recording on or off. Switching on reads the clock
    anchor that ``unix_ns`` converts with."""
    global _ON, _ANCHOR, _PROFILING, _RANGE
    if on and not _ON:
        import torch
        _PROFILING = getattr(torch._C._autograd, "_profiler_enabled", None)
        _RANGE = torch.profiler.record_function
        with _RANGE("debug.tracing"):   # its first call is slow
            pass
        _ANCHOR = _anchor()
    _ON = bool(on)


def spans() -> Spans:
    """Take the recorded spans (and the count dropped) and clear both."""
    global _BUF, _DROPPED
    with _LOCK:
        out = Spans(_BUF)
        out.dropped = _DROPPED
        _BUF, _DROPPED = [], 0
    return out


def _anchor() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) of one instant: of a few paired
    readings, the one whose perf_counter bracket is narrowest."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def unix_ns(t_perf_ns: int) -> int:
    """A span's ``perf_counter_ns`` reading on the wall clock (ns since
    the epoch), through the anchor read when tracing was switched on."""
    return t_perf_ns - _ANCHOR[0] + _ANCHOR[1]


def merge(trace_path: str, recorded) -> None:
    """Add the spans that the profiler's timeline lacks to the Chrome
    trace it exported, on its clock: ``ts`` in microseconds = (wall-clock
    ns - the trace's ``baseTimeNanoseconds``) / 1000; each on its thread's
    track (``tid`` the native thread id, named by a ``thread_name``
    event), with its span, parent and request ids and its counts in
    ``args``; and the count of dropped spans as ``programSpansDropped``."""
    with open(trace_path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events, tids = trace["traceEvents"], set()
    for s in recorded:
        if s.profiled:
            continue
        tids.add(s.tid)
        args = {"span": s.sid, "parent": s.parent, "request": s.rid}
        args.update(s.counts)
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name,
                       "pid": pid, "tid": s.tid,
                       "ts": (unix_ns(s.t0) - base) / 1000.0,
                       "dur": (s.t1 - s.t0) / 1000.0, "args": args})
    for tid in sorted(tids):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": _THREADS.get(tid, "")}})
    trace["programSpansDropped"] = getattr(recorded, "dropped", 0)
    with open(trace_path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile(trace_dir: str | None, device="cuda"):
    """A torch.profiler trace of the region into ``trace_dir`` when it is
    set, recording the card's activity where ``device`` is a CUDA device,
    with tracing on and the region's spans merged in; no-op else."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was_on = _ON
    tracing(True)
    first = len(_BUF)

    def ready(prof) -> None:
        path = os.path.join(trace_dir, f"{socket.gethostname()}_"
                            f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with _LOCK:
            got = Spans(_BUF[first:])
            got.dropped = _DROPPED
        merge(path, got)

    try:
        with torch.profiler.profile(activities=activities,
                                    on_trace_ready=ready):
            try:
                yield
            finally:
                if cuda and torch.cuda.is_initialized():
                    torch.cuda.synchronize()   # the launches end inside
    finally:
        if not was_on:
            tracing(False)
            spans()
