"""Debug tracing and the profiler hook of the port.

The counterpart of ``niqki_tpu/debug.py``. The reference's compile-time
DEBUG_MSG macros become a runtime switch:

    NIQKI_TPU_DEBUG=1   engine-level trace (files, batches, timings)
    NIQKI_TPU_DEBUG=2   + per-record detail

``profile(trace_dir, device)`` wraps a region in ``torch.profiler``: host
activity always, the card's kernels and copies too where the run's device
is ``cuda``. The trace is written into ``trace_dir`` as a Chrome/TensorBoard
``*.pt.trace.json`` when the region ends.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

LEVEL = int(os.environ.get("NIQKI_TPU_DEBUG", "0") or "0")


def dbg(msg: str, level: int = 1) -> None:
    if LEVEL >= level:
        print(f"[niqki_tpu +{time.monotonic():.3f}] {msg}",
              file=sys.stderr, flush=True)


@contextlib.contextmanager
def span(name: str, level: int = 1):
    """Time a host-side region and log it at the given debug level."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        dbg(f"{name}: {time.monotonic() - t0:.4f}s", level)


@contextlib.contextmanager
def profile(trace_dir: str | None, device="cuda"):
    """A torch.profiler trace of the region into ``trace_dir`` when it is
    set, recording the card's activity where ``device`` is a CUDA device;
    no-op else."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(trace_dir)):
        try:
            yield
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()   # the region's launches end inside
