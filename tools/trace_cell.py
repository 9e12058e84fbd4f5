#!/usr/bin/env python3
"""Where a benchmark cell's time goes, by the program's own spans, and
what switching the spans on costs:

    python3 tools/trace_cell.py --cell synth100k_s12.query --seed N \\
        [--seconds S] [--cost-seconds C] [--out FILE] [--small --device cpu]

One set-up of the cell (``benchmark/harness.py``'s loop), then:

1. ``--cost-seconds`` > 0: four windows with the program's tracing off,
   on, on, off (``niqki_tpu_torch.debug.tracing``), each giving the cell's
   end-to-end metric as the benchmark computes it.
2. One traced window of ``--seconds`` (the traffic's ``trace_seconds``
   where shorter), under ``torch.profiler`` on the loop's thread (host
   and, on a card, device activity), with the benchmark's probes
   (``benchmark/spans.py``) and the program's tracing on. The profiler's
   trace is reduced as the benchmark reduces it (``benchmark/trace.py``);
   then the program's spans are merged into it on the profiler's clock
   (``debug.merge``), and
   - the device's idle time is split exactly by the innermost program
     span open on the loop's thread and the innermost one open on any
     other thread, each stretch beside the label that the benchmark's
     reduction gives its gap when the program's own ranges are left out
     of the trace (as a program without spans would leave them); this
     split goes once ``benchmark/trace.py`` labels each gap by the
     innermost program span itself;
   - the program's spans on the loop's thread are checked to cover the
     window (their union's share);
   - each loop-thread span that the profiler's timeline also holds is
     matched to that range: the differences of their starts measure the
     clock conversion (absolute, and signed over the window's first and
     last quarters, which shows a drift);
   - the seconds of each span name inside the window, on the loop's
     thread and on the others.

Also the cost of one span, off and on, in ns (a loop of 200,000).
Prints, and writes to ``--out``, one JSON object. ``--small`` takes the
small stand-ins of ``benchmark/tests/small.py`` (for the CPU).
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _context(cell: str, seed: int, seconds: float, device: str, small: bool):
    import importlib
    import torch
    from benchmark import harness
    cell_d = {c["name"]: c for c in harness.load_spec()["workloads"]}[cell]
    if small:
        from benchmark.tests import small as sm
        config, traffic = sm.cell_parts(cell)
    else:
        config = harness.load_json("configs", cell_d["config"])
        traffic = harness.load_json("traffic", cell_d["traffic"])
    loop = importlib.import_module("benchmark.loops." + traffic["loop"])
    tmp = tempfile.mkdtemp(prefix="niqki_trace_")
    ctx = harness.Context(cell_d, config, traffic, seed, seconds, True,
                          torch.device(device), tmp)
    return ctx, loop


def _e2e(values: dict) -> tuple[str, float]:
    (name, v), = values.items()
    return name, v


def cost_windows(ctx, loop, seconds: float) -> dict:
    """The end-to-end metric of four windows: tracing off, on, on, off."""
    from niqki_tpu_torch import debug
    out = {"off": [], "on": []}
    name = None
    for on in (False, True, True, False):
        debug.tracing(on)
        gc.collect()
        values = loop.window(ctx, seconds)
        debug.tracing(False)
        got = debug.spans()
        name, v = _e2e(values)
        out["on" if on else "off"].append(v)
        print(f"cost window tracing {'on ' if on else 'off'}: {name} {v} "
              f"({len(got)} spans, {got.dropped} dropped)", flush=True)
    return {"metric": name, **out}


def _intervals_union(iv):
    iv = sorted(iv)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Open:
    """The innermost (latest-started) of some spans open at an instant."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s.t0)
        self.starts = [s.t0 for s in self.spans]

    def at(self, t_ns):
        for k in range(bisect.bisect_right(self.starts, t_ns) - 1, -1, -1):
            if self.spans[k].t1 > t_ns:
                return self.spans[k]
        return None


def traced_window(ctx, loop, workdir: str) -> dict:
    import torch
    from benchmark import trace as tr
    from benchmark.spans import Probes, label_program
    from niqki_tpu_torch import debug
    seconds = min(ctx.seconds, ctx.traffic.get("trace_seconds", ctx.seconds))
    probes = Probes()
    label_program(probes)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    debug.tracing(True)
    main_tid = threading.get_native_id()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            t0 = time.perf_counter_ns()
            values = loop.window(ctx, seconds)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
    debug.tracing(False)
    spans = debug.spans()
    probes.restore()
    path = os.path.join(workdir, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    reduced = tr.reduce(events)
    base = int(trace.get("baseTimeNanoseconds", 0))
    debug.merge(path, spans)
    with open(path) as f:
        merged = json.load(f)["traceEvents"]
    os.remove(path)

    def us(t_ns):        # a span's perf_counter_ns on the trace's clock
        return (debug.unix_ns(t_ns) - base) / 1000.0

    def ns(t_us):
        return int(t_us * 1000.0 + base - debug.unix_ns(0))

    win = [e for e in events if e.get("name") == tr.WINDOW
           and e.get("ph") == "X"][0]
    w0_us, w1_us = win["ts"], win["ts"] + win["dur"]
    inside = [s for s in spans if s.t1 > t0 and s.t0 < t1]

    # the device's idle gaps, as the benchmark's reduction finds them
    dev = [(max(e["ts"], w0_us), min(e["ts"] + e.get("dur", 0), w1_us))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in tr.DEVICE_CATS
           and e["ts"] + e.get("dur", 0) > w0_us and e["ts"] < w1_us]
    busy = _intervals_union([(a, b) for a, b in dev if b > a])
    gaps, cur = [], w0_us
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1_us:
        gaps.append((cur, w1_us))
    host = sorted((max(e["ts"], w0_us),
                   min(e["ts"] + e.get("dur", 0), w1_us), e.get("name", ""))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in tr.HOST_CATS
                  and e.get("name") != tr.WINDOW
                  and e["ts"] + e.get("dur", 0) > w0_us and e["ts"] < w1_us)
    loop_open = _Open(s for s in inside if s.tid == main_tid)
    other_open = _Open(s for s in inside if s.tid != main_tid)
    ours = {s.name for s in spans}
    host = [h for h in host if h[2] not in ours]
    edges = sorted({x for s in inside for x in (us(s.t0), us(s.t1))})
    table = defaultdict(float)
    active, j = [], 0
    for mid, a, b in sorted(((a + b) / 2, a, b) for a, b in gaps):
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = tr._label(active)
        cut = [a] + edges[bisect.bisect_right(edges, a):
                          bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cut, cut[1:]):
            at = ns((x + y) / 2)
            m, o = loop_open.at(at), other_open.at(at)
            table[(label, m.name if m else "-", o.name if o else "-")] += \
                (y - x) * 1e-6
    gaps_out = sorted(([*k, v] for k, v in table.items()),
                      key=lambda r: -r[3])

    # the loop thread's spans cover the window
    mine = _intervals_union([(max(s.t0, t0), min(s.t1, t1)) for s in inside
                             if s.tid == main_tid])
    cover = sum(b - a for a, b in mine) / (t1 - t0)

    # the clock: loop-thread spans the profiler's timeline holds too
    ranges = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("tid") == main_tid:
            ranges[e["name"]].append(e["ts"])
    for v in ranges.values():
        v.sort()
    diffs, signed = [], []
    for s in inside:
        if s.profiled and s.tid == main_tid and ranges.get(s.name):
            r = ranges[s.name]
            x = us(s.t0)
            k = bisect.bisect_left(r, x)
            y = min(r[max(0, k - 1):k + 1], key=lambda y: abs(x - y))
            diffs.append(abs(x - y))
            signed.append(((x - w0_us) / (w1_us - w0_us), x - y))
    early = [d for f, d in signed if f < 0.25]
    late = [d for f, d in signed if f >= 0.75]

    # seconds of each span name inside the window, by thread
    per = defaultdict(float)
    for s in inside:
        where = "loop" if s.tid == main_tid else "other"
        per[(s.name, where)] += (min(s.t1, t1) - max(s.t0, t0)) * 1e-9
    merged_prog = sum(1 for e in merged if e.get("ph") == "X"
                      and isinstance(e.get("args"), dict)
                      and "request" in e["args"])
    return {
        "values": values, "window_s": (t1 - t0) * 1e-9,
        "busy_s": reduced["busy_s"], "idle_pct": 100.0 * (
            1 - reduced["busy_s"] / reduced["window_s"]),
        "harness_idle_gaps": reduced["idle_gaps"],
        "idle_by_label_and_span": gaps_out[:40],
        "loop_thread_cover": cover,
        "clock_us": {"n": len(diffs),
                     "median": statistics.median(diffs) if diffs else None,
                     "max": max(diffs) if diffs else None,
                     "signed_first_quarter": statistics.median(early)
                     if early else None,
                     "signed_last_quarter": statistics.median(late)
                     if late else None},
        "span_seconds": sorted(([n, w, v] for (n, w), v in per.items()),
                               key=lambda r: -r[2]),
        "spans": len(spans), "dropped": spans.dropped,
        "merged_events": merged_prog,
        "threads": len({s.tid for s in inside}),
    }


def span_cost(n: int = 200_000) -> dict:
    """ns a span costs, tracing off and on (a span with a count, set
    where it records), less the empty loop's; ``n`` stays below the
    buffer's ``debug.CAP``."""
    from niqki_tpu_torch import debug

    def loop(k, with_span):
        t = time.perf_counter_ns()
        for _ in range(k):
            if with_span:
                with debug.span("cost", 2) as sp:
                    if sp:
                        sp.set(rows=1)
        return time.perf_counter_ns() - t
    out = {}
    for on in (False, True):
        debug.tracing(on)
        out["on" if on else "off"] = (loop(n, True) - loop(n, False)) / n
        debug.tracing(False)
        debug.spans()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    ctx, loop = _context(args.cell, args.seed, args.seconds, args.device,
                         args.small)
    result = {"cell": args.cell, "seed": args.seed}
    if ctx.device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(ctx.device)
    try:
        result["span_ns"] = span_cost()
        t = time.time()
        loop.setup(ctx)
        result["setup_s"] = time.time() - t
        if args.cost_seconds > 0:
            result["cost"] = cost_windows(ctx, loop, args.cost_seconds)
        result["traced"] = traced_window(ctx, loop, ctx.tmp)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
