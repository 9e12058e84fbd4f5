"""Spans taken from the benchmark's own files, around calls into the
program's layers.

``Probes.wrap`` replaces a function or method of a program module by a
wrapper that records a span (host clock, optionally ending in a
synchronize) and names the call in the profiler's timeline
(``torch.profiler.record_function``), numbered where a reader needs the
device time of each call's kernels. Probes are
installed only in a traced run (``--trace 1``) and removed before the
check of the outputs, so the end-to-end runs call the program untouched.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import torch

PREFIX = "bench::"


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    call: int | None = None
    info: object = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def tagged(name: str, call: int) -> str:
    """The name of call ``call`` of probe ``name`` in the profiler's
    timeline, which ``trace.reduce`` reads back."""
    return f"{PREFIX}{name}#{call}"


@dataclass
class Probes:
    spans: dict = field(default_factory=dict)
    _undo: list = field(default_factory=list)
    _calls: dict = field(default_factory=dict)

    def wrap(self, owner, attr: str, name: str, *, tag: bool = False,
             sync: bool = False, info=None, static: bool = False) -> None:
        """Wrap ``owner.attr``. ``tag`` numbers each call in the profiler's
        timeline (``tagged``), so that the trace's reduction can hand back
        the device time of the kernels each call launched; ``info(args,
        kwargs, result)`` keeps what a reader needs of the call (shapes);
        ``static`` re-wraps a staticmethod."""
        orig = owner.__dict__[attr] if static else getattr(owner, attr)
        fn = orig.__func__ if static else orig
        rec = self.spans.setdefault(name, [])
        calls = self._calls.setdefault(name, itertools.count())

        def wrapper(*args, **kwargs):
            i = next(calls) if tag else None
            label = tagged(name, i) if tag else PREFIX + name
            with torch.profiler.record_function(label):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                rec.append(Span(name, t0, t1, i,
                                info(args, kwargs, out) if info else None))
            return out

        setattr(owner, attr, staticmethod(wrapper) if static else wrapper)
        self._undo.append((owner, attr, orig))

    def restore(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


def within(spans, t0: float, t1: float) -> float:
    """Seconds of the spans that lie inside [t0, t1]."""
    return sum(max(0.0, min(s.t1, t1) - max(s.t0, t0)) for s in spans)


def label_program(probes: Probes) -> None:
    """Name the program's entry points in the traced timeline, so the
    device's idle gaps can be told apart by what the host was doing."""
    from niqki_tpu_torch import engine, native
    from niqki_tpu_torch.index import SketchIndex
    from niqki_tpu_torch.io.writers import GzTextWriter
    from niqki_tpu_torch.ops import bcount
    for attr in ("query_fof_whole", "insert_file_lines"):
        probes.wrap(engine, attr, "engine." + attr)
    for attr in ("sketch_files", "sketch_file", "pretty_hits_batch",
                 "_planes", "counts", "matrix"):
        probes.wrap(SketchIndex, attr, "SketchIndex." + attr)
    probes.wrap(native.HitsFormatter, "format_sparse",
                 "HitsFormatter.format_sparse")
    probes.wrap(native, "sketch_packed_batch", "native.sketch_packed_batch")
    probes.wrap(bcount, "build_index_planes", "bcount.build_index_planes")
    probes.wrap(GzTextWriter, "_member", "GzTextWriter._member", static=True)
