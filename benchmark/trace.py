"""Reduction of a ``torch.profiler`` trace of the measured window.

The trace is read as the profiler exports it (chrome trace JSON): device
activity is its ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events, host
activity its ``cpu_op`` and ``user_annotation`` events.

``busy_s`` is the length of the union of the device's activity intervals
(kernels, copies and fills) inside the traced window; ``window_s`` is the
window's length. ``breakdown`` lists the device operations that took most
time, and the device's idle gaps summed by what the host was doing: the
innermost benchmark span (``spans.PREFIX``) or, failing one, the innermost
host-side operation that covers the middle of the gap, on any thread.
The profiler has been seen to leave out some short launches, so
``busy_s`` is a floor.

``calls`` gives, for each numbered probe call (``spans.tagged``) in the
window, the kernel launches its thread issued inside the call (the
runtime's launch events), how many of those kernels the trace holds (by
correlation id) and their device seconds: a reader of a kernel's time
takes the calls whose every kernel the trace holds.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

from .harness import log
from .spans import PREFIX

WINDOW = "benchmark_window"     # the range that marks the traced window


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def from_profiler(prof, directory: str) -> dict:
    """Export the profiler's trace as JSON into ``directory`` and reduce
    it (reading the exported file is far quicker than the profiler's own
    event objects)."""
    path = os.path.join(directory, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def reduce(events) -> dict:
    """busy_s, window_s and the breakdown of the trace's complete events
    (chrome trace format: ``ph`` X, ``cat``, ``name``, ``ts``, ``dur`` in
    microseconds) inside the window."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""),
              e.get("cat", "")) for e in events if e.get("ph") == "X"]
    win = [(a, b) for a, b, n, c in spans
           if n == WINDOW and c in HOST_CATS]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0_us, w1_us = win[0]
    dev, host = [], []
    for a, b, name, cat in spans:
        if b <= w0_us or a >= w1_us or b <= a or name == WINDOW:
            continue
        if cat in DEVICE_CATS:
            dev.append((max(a, w0_us), min(b, w1_us), name[:160]))
        elif cat in HOST_CATS:
            host.append((max(a, w0_us), min(b, w1_us), name))
    dev.sort()
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            elif a > w0_us:
                gaps.append((w0_us, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        if cur_b < w1_us:
            gaps.append((cur_b, w1_us))
    else:
        gaps.append((w0_us, w1_us))
    ops = defaultdict(float)
    for a, b, name in dev:
        ops[name] += (b - a) * 1e-6
    idle = defaultdict(float)
    host.sort()
    active, j = [], 0
    for mid, length in sorted(((a + b) / 2, b - a) for a, b in gaps):
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        idle[_label(active)] += length * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (w1_us - w0_us) * 1e-6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in top_idle],
            "calls": tagged_calls(events, w0_us, w1_us)}


def tagged_calls(events, w0_us: float, w1_us: float) -> dict:
    """{probe: {call: [issued, recorded, device seconds]}} of the numbered
    probe calls that start inside the window (see the module's text)."""
    ranges = defaultdict(list)          # (pid, tid) -> [(a, b, probe, call)]
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("cat") in HOST_CATS
                and name.startswith(PREFIX) and "#" in name
                and w0_us <= e["ts"] < w1_us):
            probe, call = name[len(PREFIX):].rsplit("#", 1)
            ranges[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e.get("dur", 0), probe, int(call)))
    for r in ranges.values():
        r.sort()
    kern = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            cid = (e.get("args") or {}).get("correlation")
            if cid is not None:
                kern[cid] = e.get("dur", 0) * 1e-6
    out = defaultdict(dict)
    for r in ranges.values():
        for _, _, probe, call in r:
            out[probe][call] = [0, 0, 0.0]
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") not in RUNTIME_CATS
                or e.get("name") not in LAUNCHES):
            continue
        r = ranges.get((e.get("pid"), e.get("tid")))
        if not r:
            continue
        k = bisect.bisect_right(r, (e["ts"], float("inf"))) - 1
        if k < 0 or e["ts"] > r[k][1]:
            continue
        c = out[r[k][2]][r[k][3]]
        c[0] += 1
        cid = (e.get("args") or {}).get("correlation")
        if cid in kern:
            c[1] += 1
            c[2] += kern[cid]
    return dict(out)


def kernel_share(ctx, probe: str, least) -> float | None:
    """A kernel's share of its roofline over the traced window, in %: the
    least time ``least(info)`` of the probe's calls over the device time of
    the kernels they launched, taken over the calls whose every launch the
    trace holds (the others are counted on standard error); None where no
    call is whole."""
    got = ((ctx.trace_result or {}).get("calls") or {}).get(probe, {})
    spans = ctx.probes.spans.get(probe, [])
    whole = [(s, got[s.call]) for s in spans
             if s.call in got and got[s.call][0] == got[s.call][1] > 0]
    if len(whole) < len(spans):
        log(f"{probe}: {len(spans) - len(whole)} of {len(spans)} calls "
            f"left out of its roofline share (the trace lacks a launch)")
    if not whole:
        return None
    return 100.0 * sum(least(s.info) for s, _ in whole) / sum(
        c[2] for _, c in whole)


def _label(active) -> str:
    """The innermost benchmark span among the host ranges ``active`` (the
    latest to start), else the innermost host operation, else ``host:
    outside any traced call``."""
    spans = [h for h in active if h[2].startswith(PREFIX)]
    if spans:
        return max(spans)[2][len(PREFIX):].split("#", 1)[0].split("#", 1)[0]
    if active:
        return max(active)[2]
    return "host: outside any traced call"
