"""One run of one cell of the benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, whose ``loop`` names a module of
``loops/``, and each per-layer metric in ``metrics/<name>.py`` (or, for
``<base>.<cell kind>``, ``metrics/<base>.py``). Adding a cell, a mix or a
metric adds files and entries; no file here changes.

A loop has ``setup(ctx)`` (inputs from the seed, the program's state in
``ctx.state``, the warm-up), ``window(ctx, seconds)`` (the measured loop;
returns the end-to-end values; what it produced stays in ``ctx.data``),
``judge(ctx)`` (the comparison of ``ctx.data``'s outputs with the plain
reference, once the window has closed and ``ctx.state`` is freed; returns
the checks) and ``control(ctx, bits)`` (the same inputs, and in
``ctx.data`` the outputs of the reference at fingerprints ``bits``
narrower in the program's place, for ``judge``; see ``control.py``). A metric module has ``read(ctx)`` and optionally
``install(ctx)``, which sets probes before a traced window.

The run prints, as its last lines on standard error, each number compared
beside its limit, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``checks``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "niqki_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def log(msg: str) -> None:
    """A line of progress on standard error (before the check's lines)."""
    print(f"bench +{time.time() - _T0:8.2f}s {msg}", file=sys.stderr,
          flush=True)


_T0 = process_start()


@dataclass
class Check:
    """One number compared with its limit: ok while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """What one run carries from set-up through the window to the check."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str
    state: dict = field(default_factory=dict)    # the program's objects
    data: dict = field(default_factory=dict)     # inputs and outputs kept
    probes: object = None
    trace_result: dict | None = None
    window_t: tuple = (0.0, 0.0)
    attempted: int = 0
    failed: int = 0
    write: bool = True      # the inputs go to files (not for the control)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def metric_module(name: str):
    """The reader of a per-layer metric: metrics/<name>.py, else
    metrics/<name up to its first dot>.py."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "benchmark.metrics." + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} in metrics/")


def cell_metrics(spec: dict, cell: str, kind: str) -> list:
    """The cell's end-to-end or per-layer metrics: those whose
    ``workloads`` list it, or that have no such list."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def _parts(cell_name: str, spec, config, traffic) -> tuple:
    """(spec, cell, config, traffic, loop module) of a cell by its name."""
    spec = spec or load_spec()
    cells = {c["name"]: c for c in spec["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    config = config or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    loop = importlib.import_module("benchmark.loops." + traffic["loop"])
    return spec, cell, config, traffic, loop


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", spec: dict | None = None, config: dict | None = None,
        traffic: dict | None = None, t_start: float | None = None) -> dict:
    """One run; returns the result object. ``device``, ``config`` and
    ``traffic`` are for tests, which drive a run on the CPU at a small
    size; the benchmark's runs take them from the files."""
    import torch
    t_start = process_start() if t_start is None else t_start
    spec, cell, config, traffic, loop = _parts(cell_name, spec, config,
                                               traffic)
    e2e = cell_metrics(spec, cell_name, "end_to_end")
    layer = cell_metrics(spec, cell_name, "per_layer") if trace else []
    readers = [(m, metric_module(m["name"])) for m in layer]
    tmp = tempfile.mkdtemp(prefix="niqki_bench_")
    ctx = Context(cell, config, traffic, seed, seconds, trace,
                  torch.device(device), tmp)
    try:
        log(f"{cell_name} seed {seed}: set-up")
        loop.setup(ctx)
        if trace:
            from .spans import Probes, label_program
            ctx.probes = Probes()
            label_program(ctx.probes)
            for _, mod in readers:
                if hasattr(mod, "install"):
                    mod.install(ctx)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        log(f"window of {seconds} s (set-up {setup_s:.2f} s)")
        values = _window(ctx, loop, trace)
        calls = sorted(b - a for a, b, _ in ctx.data.get("done", ()))
        if calls:
            log(f"window closed: {values}; {len(calls)} calls of "
                f"{calls[0]:.4f} / {calls[len(calls) // 2]:.4f} / "
                f"{calls[-1]:.4f} s (min / median / max)")
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if ctx.device.type == "cuda" else 0)
        metrics = {}
        if trace:
            for m, mod in readers:
                v = mod.read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            ctx.probes.restore()
        else:
            values["setup_s"] = setup_s
            for m in e2e:
                if m["name"] not in values:
                    raise RuntimeError(f"loop {traffic['loop']} gave no "
                                       f"{m['name']}")
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        ctx.state.clear()
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        log("check against the reference")
        checks = loop.judge(ctx)
        log("check done")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks) and ctx.failed == 0,
              "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.trace_result is not None:
        dev["busy_s"] = ctx.trace_result["busy_s"]
        dev["window_s"] = ctx.trace_result["window_s"]
        result["breakdown"] = {k: ctx.trace_result[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def control_run(cell_name: str, seed: int, bits: int = 1, *,
                device="cuda", spec: dict | None = None,
                config: dict | None = None, traffic: dict | None = None
                ) -> dict:
    """The cell's check with the plain reference, its fingerprints ``bits``
    narrower, in the program's place (``bits`` 0: the reference itself):
    the loop's ``control`` fills the outputs a window would leave, and its
    ``judge`` decides ``correct`` as in a run. Writes no inputs and runs
    no program."""
    import torch
    _, cell, config, traffic, loop = _parts(cell_name, spec, config,
                                            traffic)
    ctx = Context(cell, config, traffic, seed, 0.0, False,
                  torch.device(device), "", write=False)
    loop.control(ctx, bits)
    checks = loop.judge(ctx)
    return {"correct": all(c.ok for c in checks) and ctx.failed == 0,
            "checks": {c.name: {"value": c.value, "limit": c.limit}
                       for c in checks}}


def _window(ctx: Context, loop, trace: bool) -> dict:
    """The measured window, under the profiler when traced."""
    import torch
    if not trace:
        t0 = time.perf_counter()
        values = loop.window(ctx, ctx.seconds)
        ctx.window_t = (t0, time.perf_counter())
        return values
    from . import trace as tr
    # a traffic file may trace a shorter window: the profiler's own
    # reading costs about 100 ms a second of small requests
    seconds = min(ctx.seconds, ctx.traffic.get("trace_seconds",
                                               ctx.seconds))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            t0 = time.perf_counter()
            values = loop.window(ctx, seconds)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize()
            ctx.window_t = (t0, time.perf_counter())
    ctx.trace_result = tr.from_profiler(prof, ctx.tmp)
    return values


def main(argv=None) -> int:
    import argparse
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    spec = load_spec()
    chips = {c["name"]: c.get("chips", 1)
             for c in spec["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 spec=spec, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print("benchmark: the run loaded " + ", ".join(bad)
              + ": the port and the harness must not import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
