"""The port's debug switch and profiler hook (``niqki_tpu_torch.debug``):
``--profile`` writes a torch.profiler trace that parses, without changing
a byte of the run's output; ``dbg``/``span`` log at NIQKI_TPU_DEBUG.
"""

import glob
import gzip
import json
import os
import subprocess
import sys

import pytest

from niqki_tpu import native
from niqki_tpu_torch import cli, debug

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FOF = f"{FIXDIR}/fof_tiny.txt"


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_cli_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    """-I/-Q with --profile on the CPU: the output bytes of the run
    without it, and one Chrome trace in the directory that parses as JSON
    and holds the run's torch operations."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "q.txt").write_text(f"{FIXDIR}/tiny2.fa\n{FIXDIR}/multi.fa\n")
    args = ["-I", FOF, "-Q", "q.txt", "-S", "12", "-K", "21", "-J", "0.05",
            "--device", "cpu"]
    assert cli.main(args + ["-O", "plain.gz"]) == 0
    assert cli.main(args + ["-O", "prof.gz", "--profile", "tr"]) == 0
    assert _gz("prof.gz") == _gz("plain.gz")
    assert b"tiny2.fa:1 " in _gz("prof.gz")
    traces = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "Number of indexed genomes" in capsys.readouterr().out


def test_profile_without_a_directory_is_a_no_op(monkeypatch):
    """No --profile: the profiler is never started, on either device."""
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("the profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for trace_dir, device in ((None, "cuda"), ("", "cpu")):
        with debug.profile(trace_dir, device):
            pass


def test_dbg_and_span_follow_the_level(monkeypatch, capsys):
    monkeypatch.setattr(debug, "LEVEL", 1)
    debug.dbg("shown")
    debug.dbg("hidden", level=2)
    with debug.span("region"):
        pass
    with debug.span("detail", level=2):
        pass
    err = capsys.readouterr().err
    assert "] shown" in err and "hidden" not in err
    assert "] region: " in err and "detail" not in err
    monkeypatch.setattr(debug, "LEVEL", 0)
    debug.dbg("quiet")
    assert capsys.readouterr().err == ""


def test_debug_env_traces_the_sketch_windows(tmp_path):
    """NIQKI_TPU_DEBUG=1 in a fresh process: the CLI's -I logs each sketch
    window of SketchIndex.sketch_files on stderr; unset, it logs nothing."""
    env = dict(os.environ, NIQKI_TPU_DEBUG="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    cmd = [sys.executable, "-m", "niqki_tpu_torch.cli", "-I", FOF, "-S",
           "10", "-K", "21", "-O", str(tmp_path / "o.gz"), "--device", "cpu"]
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[niqki_tpu +" in res.stderr
    assert "window @0: 3 files, 3 records" in res.stderr
    env["NIQKI_TPU_DEBUG"] = "0"
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "window @" not in res.stderr


def test_cli_profile_merges_the_worker_spans(tmp_path, monkeypatch):
    """--profile switches the port's spans on for the run: its trace holds
    each span once, on its own thread's track, the prefetch thread's
    beside the calling thread's, with their request ids; tracing is off
    again after the run."""
    import threading
    monkeypatch.chdir(tmp_path)
    (tmp_path / "q.txt").write_text(f"{FIXDIR}/tiny2.fa\n{FIXDIR}/multi.fa\n")
    assert debug.span("x") is debug.NULL
    assert cli.main(["-I", FOF, "-Q", "q.txt", "-S", "12", "-K", "21", "-J",
                     "0.05", "--device", "cpu", "-O", "o.gz", "--profile",
                     "tr"]) == 0
    assert debug.span("x") is debug.NULL and len(debug.spans()) == 0
    trace_path, = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    with open(trace_path) as f:
        trace = json.load(f)
    assert trace["programSpansDropped"] == 0
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    main = threading.get_native_id()

    def named(n):
        return [e for e in ev if e["name"] == n]

    # the calling thread's spans come from the profiler's own ranges
    for n in ("engine.insert", "engine.query", "engine.sketch_wait",
              "writer.close"):
        e, = named(n)
        assert e["tid"] == main and e["cat"] == "user_annotation"
    # the prefetch thread's are merged, once each, off the calling thread
    sk = named("index.sketch_files")
    assert len(sk) == 2 and len({e["tid"] for e in sk}) == 2
    q = [e for e in sk if e["tid"] != main][0]
    assert q["args"]["files"] == 2 and q["args"]["batched"] == 2
    # one read a window, on the thread of its sketch_files: the insert's
    # three files on the calling thread, the query's two on the prefetch
    # thread, in the query's request
    reads = named("index.read")
    assert len(reads) == 2
    ins, = [e for e in reads if e["tid"] == main]
    assert ins["cat"] == "user_annotation"
    qr, = [e for e in reads if e["tid"] != main]
    assert qr["tid"] == q["tid"]
    assert qr["args"]["request"] == q["args"]["request"]
    assert (qr["args"]["files"], qr["args"]["records"],
            qr["args"]["threads"]) == (2, 3, min(2, os.cpu_count() or 1))
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {e["tid"] for e in reads} <= set(names)
