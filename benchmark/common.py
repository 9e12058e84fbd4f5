"""What the loops share: the program's parameters, inputs written where
the program reads them, the in-memory sink of the program's writer, the
closed loop of the window, the arithmetic of the end-to-end metrics and
the comparison of text rows with the plain reference."""

from __future__ import annotations

import gzip
import hashlib
import math
import os
import random
import time

import numpy as np
import torch

from . import gen
from . import reference as ref
from .harness import log


def program_params(cfg: dict):
    from niqki_tpu_torch.params import SketchParams
    p = cfg["params"]
    return SketchParams(lF=p["S"], K=p["K"], W=p["W"], H=p["H"],
                        min_fract=p["J"])


def reference_params(cfg: dict, bits: int = 0) -> ref.Params:
    """The reference's parameters, with fingerprints ``bits`` narrower
    for the control."""
    p = cfg["params"]
    return ref.Params(p["K"], p["S"], p["W"] - bits, p["H"], p["J"])


def narrower(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Sketches at ``bits`` bits less: every fingerprint shifted right,
    empty slots left empty."""
    return torch.where(x >= 0, x >> bits, x) if bits else x


def make_index_inputs(ctx) -> None:
    """The configuration's genomes from the seed, written as one
    multi-FASTA in the run's temporary directory (``ctx.data['fasta']``;
    gzipped where the traffic's ``index_gzip`` says so, for cells that
    read it only in set-up) and flushed to disk, so that no write-back of
    them runs in the window. The control (``ctx.write`` false) writes
    nothing."""
    g = gen.make_genomes(ctx.config["genomes"], ctx.seed, ctx.device)
    ctx.data["genomes"] = g
    log(f"{g.G} genomes, {g.bases} bases drawn")
    gz = ctx.traffic.get("index_gzip", False)
    ctx.data["fasta"] = os.path.join(ctx.tmp, "index.fa" + (".gz" if gz
                                                             else ""))
    ctx.data["bases"] = g.bases
    ctx.data["index_names"] = [">" + n for n in g.names]
    if ctx.write:
        g.write_fasta(ctx.data["fasta"], gz)
        os.sync()   # the write-back of the inputs ends before the window
        log("multi-FASTA written")


def make_query_pool(ctx, n: int) -> list:
    """``n`` mutant query genomes (the traffic's ``query_mutation``), one
    FASTA file each, flushed to disk (not for the control); returns their
    paths, which name the queries in the program's rows."""
    q, _ = gen.make_queries(ctx.data["genomes"], n,
                            ctx.traffic["query_mutation"], ctx.seed,
                            ctx.device)
    ctx.data["queries"] = q
    directory = os.path.join(ctx.tmp, "queries")
    if ctx.write:
        paths = q.write_each(directory)
        os.sync()
        log(f"{n} query files written")
    else:
        paths = [os.path.join(directory, name + ".fa") for name in q.names]
    ctx.data["query_paths"] = paths
    return paths


def reset_peak(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)


def build_index(ctx):
    """A fresh index of the multi-FASTA through the port's -i ingest."""
    from niqki_tpu_torch import SketchIndex, engine
    idx = SketchIndex(program_params(ctx.config), device=ctx.device)
    engine.insert_file_lines(idx, ctx.data["fasta"])
    log(f"index of {idx.G} genomes built")
    return idx


def sync(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


class Sink:
    """The file object of a ``GzTextWriter``: the gzip members it writes
    stay in memory, and nothing reaches a disk."""

    def __init__(self):
        self.parts: list = []
        self.nbytes = 0

    def write(self, b) -> int:
        self.parts.append(bytes(b))
        self.nbytes += len(b)
        return len(b)

    def close(self) -> None:
        pass

    @classmethod
    def of(cls, text: bytes) -> "Sink":
        """A sink that holds ``text`` as one gzip member (the control's
        output in the program's place)."""
        sink = cls()
        sink.write(gzip.compress(text))
        return sink

    def text(self) -> bytes:
        return gzip.decompress(b"".join(self.parts))

    def digest(self) -> str:
        h = hashlib.sha256()
        for part in self.parts:
            h.update(part)
        return h.hexdigest()


def sink_writer():
    """(the port's GzTextWriter, its Sink): the writer deflates as it
    always does and hands its members to the sink in place of a file."""
    from niqki_tpu_torch.io.writers import GzTextWriter
    w = GzTextWriter(os.devnull)
    w._f.close()
    sink = Sink()
    w._f = sink
    return w, sink


def closed_loop(seconds: float, call) -> tuple[list, float]:
    """Call ``call(i)`` for i = 0, 1, ... one after another while the
    window of ``seconds`` lasts; the call running at its end runs to its
    end and counts. Returns ([(start, end, result)], window start) in
    host-clock seconds."""
    t0 = time.perf_counter()
    done = []
    i = 0
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        r = call(i)
        done.append((a, time.perf_counter(), r))
        i += 1
    return done, t0


def rate(units_each: float, done: list, t0: float) -> float:
    """Units per second over every call of the loop: all of them ran to
    their end, the last one past the window's end, so the rate is over
    whole calls and over all the time from the window's start until the
    last call ended."""
    return units_each * len(done) / (done[-1][1] - t0)


def p_rank(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest
    value with at least q% of all values at or below it."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def sample(seed: int, population, k: int) -> list:
    """k items of a population drawn from the seed (all where fewer)."""
    pop = list(population)
    return random.Random(seed).sample(pop, min(k, len(pop)))


def reference_sketches(ctx, genomes, rows=None) -> torch.Tensor:
    return ref.sketches(genomes.codes, genomes.offsets,
                        reference_params(ctx.config), ctx.device, rows)


def index_sketches(ctx, bits: int = 0) -> torch.Tensor:
    """The reference's sketches of every index genome, once a run
    (``bits`` narrower for the control)."""
    if "ref_index" not in ctx.data:
        ctx.data["ref_index"] = reference_sketches(ctx, ctx.data["genomes"])
        log("reference sketches of the index made")
    return narrower(ctx.data["ref_index"], bits)


def split_rows(text: bytes) -> list:
    """Rows of a text output as bytes, each with its newline."""
    return text.splitlines(keepends=True)


def hit_rows(ctx, qidx, qnames, bits: int = 0) -> list:
    """The reference's pretty hit rows of pool queries ``qidx`` named
    ``qnames`` against the whole index (``bits`` narrower for the
    control)."""
    p = reference_params(ctx.config, bits)
    q_sk = narrower(reference_sketches(ctx, ctx.data["queries"], qidx), bits)
    c = ref.counts(q_sk, index_sketches(ctx, bits), p.W)
    names = ctx.data["index_names"]
    return [ref.hits_row(n, c[i], names, p) for i, n in enumerate(qnames)]
