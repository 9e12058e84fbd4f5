#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (niqki_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     niqki_tpu_torch/csrc (one nvcc per source, in parallel; timed); the
     native host library must load.
  2. each kernel against its plain PyTorch version on the card, exactly, at
     the shapes the main path gives it, with median times of both:
     K1 (psort) at 256 x 2^17 (a batch of 100 kb records), 1 x 2^23 (an
     E. coli-sized record) and 6 x 2^23 (six 4.6 Mbp records, as
     dispatch_sketch_packed_batch batches them), each with the device time
     of its three launches (radix_hist, radix_scan, radix_scatter) from
     torch.profiler; K2 (bcount) against 4096 index rows of
     1024 lanes at the -M shape (768 index rows re-encoded as queries, one
     MATRIX_BLOCK of the self-join, P = 13) and at the -Q shape (96 packed
     queries, P = 13 and 17) and, off the main path, 96 queries against
     102,400 rows (the 4096-row planes repeated 25 times on the card; the
     counts must also equal the 4096-row counts tiled), and, measured
     beside K3 though S <= 11 does not route to it, at S = 10 (32 lanes)
     and S = 11 (64 lanes), P = 13, at the -M and -Q shapes and with all
     4096 rows as queries in one launch; K3 (pcount) at the whole count
     calls of the main path, (d) 4096 queries against 4096 rows at S = 10
     (phase 6's -M call) and (e) 96 queries against them (phase 7's -Q
     call), (f) the whole -M call at S = 11, and with 64 queries (the JAX
     package's block) against (a) 4096 rows at S = 10, (b) 102,400 rows at
     S = 10 (a 100k-genome index, 210 MB of int16) and (c) 4096 rows at
     S = 11. K2's and K3's library time is F - torch.cdist(p=0) over float
     copies of the same fingerprints, which must equal the kernel's
     counts; their device_ms is the call's device time with the host's
     share left out (device_ms), where ms (CUDA events around one call)
     also holds it.
  3. the golden matrix: -M tests/fixtures/fof_tiny.txt -S 16 -K 21 through
     the self-join must equal tests/fixtures/matrix_s16_tiny.gz.
  4. the main path at full size: -M over 4096 synthetic 100 kb genomes
     (128 clusters of 32 at 2% point mutation) with the golden sketch
     configuration (K=31, S=15, W=12, H=4) and -J 0.05. The sketch matrix
     must equal the host-native sketches, 96 sampled output rows must equal
     rows formatted from host counts, and K1 and K2 must have launched.
  5. -I/-Q: 96 query genomes (1% mutants of index genomes) against that
     index through the K2 top-k route; the output must equal the
     host-native hits.
  6. -M -S 10 -J 0.05 over the same 4096 genomes: the bit-plane gate fails,
     so the dense loop counts through one K3 launch (and launches no K2);
     sketches and 96 sampled rows must equal host-native.
  7. -I/-Q -S 10 -J 0.05 with the same queries: the dense hit route through
     one K3 launch; the output must equal the host-native hits.

The second line from the end is a JSON object with, for each kernel and
main-path shape, its launches in the run that gives it that shape (phase 4
and 5 at S=15, 6 and 7 at S=10), its error, times, bound and library time;
the last line names the device. Without a CUDA device, or without the
port's package beside it, the script fails before printing either. It
imports nothing of JAX and no module of the JAX package: the host-native
reference comes through the port (``niqki_tpu_torch.native``,
``SketchIndex`` under NIQKI_TPU_SKETCH=host).
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
G, LEN, CLUSTERS, MUT, QMUT, NQ = 4096, 100_000, 128, 0.02, 0.01, 96
S = 15          # sketch size 2^S; K=31, W=12, H=4 are the CLI defaults
SEED = 7
T0 = time.time()
# The H100 SXM's peaks (NVIDIA's data sheet): 3.35 TB/s of device memory;
# 64 INT32 lanes per SM per clock (Hopper white paper) x 132 SMs x 1.98 GHz,
# the boost clock behind the data sheet's 67 TFLOP/s of float32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.time() - T0:7.1f}s] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gz_bytes(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or int32
    operations over the INT32 instruction rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_cuda(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cdist_counts(qf, xf):
    """The library yardstick of K2 and K3, one PyTorch call: equal
    fingerprints per (query, row) as F minus torch.cdist's p=0 (Hamming)
    distance over float copies of the fingerprints (exact below 2^24)."""
    import torch
    return qf.shape[1] - torch.cdist(qf, xf, p=0)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions

def record_keys(B: int, n_bases: int, Np: int, seed: int):
    """(B, Np) int32 sketch keys of random records, made like the main
    path's (_keys_core), padded with INT32_MAX to Np."""
    import torch
    from niqki_tpu_torch import SketchParams
    from niqki_tpu_torch.ops import sketch
    p = SketchParams()
    rng = np.random.default_rng(seed)
    P = sketch.padded_size(n_bases)
    codes = torch.from_numpy(rng.integers(0, 4, (B, P), dtype=np.uint8))
    codes = codes.cuda()
    nk = torch.full((B,), n_bases - p.K, dtype=torch.int32, device="cuda")
    keys = sketch._keys_core(codes, 3 - codes, nk, lF=p.lF, K=p.K, W=p.W,
                             H=p.H)
    return torch.nn.functional.pad(keys, (0, Np - keys.shape[1]),
                                   value=sketch.INT32_MAX).contiguous()


def device_ms(fn, reps: int = 10) -> float:
    """Median device milliseconds of the work fn() queues on the card, the
    host's share left out: each call is queued behind a spin kernel
    (torch.cuda._sleep) that outlasts the host's time to queue it, between
    two CUDA events, so the card runs the call's work back to back. Every
    call is checked: the card must still be spinning when fn() returns.
    Where it is not, the spin is doubled and the call is made again; after
    8 doublings the measurement fails."""
    import torch

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    fn()
    torch.cuda.synchronize()
    a, b = events()
    a.record()
    torch.cuda._sleep(1 << 20)
    b.record()
    b.synchronize()
    cycles_per_ms = (1 << 20) / a.elapsed_time(b)
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin, doublings, times = int(cycles_per_ms * (2 * host_ms + 0.5)), 0, []
    while len(times) < reps:
        a, b = events()
        torch.cuda._sleep(spin)
        a.record()
        fn()
        ahead = not a.query()
        b.record()
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b))
            continue
        doublings += 1
        require(doublings <= 8, "device_ms: the host never got ahead of "
                "the card")
        spin *= 2
    return statistics.median(times)


def profiled_ms(fn, names, launches: int, reps: int = 5) -> dict:
    """Device milliseconds per call of fn() in the kernels whose names hold
    each of ``names``, each launched ``launches`` times a call, from a
    torch.profiler trace of ``reps`` calls; None for a name whose launches
    the trace does not all hold (its traces on the H100 have dropped some
    launches of a kernel; a mean over the rest is not taken as the
    kernel's time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    seen = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                total[name] += e.device_time_total
                seen[name] += e.count
    out = {}
    for name in names:
        if seen[name] == reps * launches:
            out[name] = total[name] / reps / 1e3
        else:
            out[name] = None
            log(f"  profiler: {seen[name]} of {reps * launches} launches of "
                f"{name} in the trace; not measured")
    return out


def psort_parts(keys) -> dict:
    """Device ms per sort of each of K1's three kernels (four launches of
    each)."""
    from niqki_tpu_torch.ops import psort
    return profiled_ms(lambda: psort.sort_i32_pow2_batch(keys),
                       ("radix_hist", "radix_scan", "radix_scatter"),
                       launches=4)


def check_psort(B: int, n_bases: int, Np: int) -> dict:
    import torch
    from niqki_tpu_torch.ops import psort
    keys = record_keys(B, n_bases, Np, seed=B)
    before = keys.clone()
    got = psort.sort_i32_pow2_batch(keys)
    want = psort.sort_plain(keys)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    require(err == 0 and torch.equal(got, want),
            f"K1 differs from torch.sort at {B}x{Np}")
    require(torch.equal(keys, before), f"K1 wrote its input at {B}x{Np}")
    del before
    ms = time_cuda(lambda: psort.sort_i32_pow2_batch(keys))
    plain_ms = time_cuda(lambda: psort.sort_plain(keys))
    # read + write of every key; four digit passes, each extracting,
    # ranking and placing every key: 4 x 4 int32 operations a key
    return {"shape": f"{B}x{Np}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": plain_ms,
            "parts_ms": psort_parts(keys),
            **bound(2 * B * Np * 4, 16 * B * Np)}


def bcount_inputs(P: int, F: int = 32768):
    """4096 index rows of F fingerprints (W = P - 1; F = 32768 is S = 15)
    with one cluster of 64 equal rows and 1% stored -2 slots, and 96
    queries drawn from them with 5% query -3 slots, 8 of them copies of row
    0: (index fingerprints, the same on the card, query fingerprints, index
    planes, query planes)."""
    import torch
    from niqki_tpu_torch.ops import bcount
    W, Qb = P - 1, bcount.BLOCK_Q
    rng = np.random.default_rng(P)
    g = rng.integers(0, 1 << W, (G, F), dtype=np.int32)
    g[:64] = g[0]                                   # one cluster of 64
    g[rng.random((G, F)) < 0.01] = -2
    q = g[rng.choice(G, Qb, replace=False)].copy()
    q[:8] = g[0]
    q[rng.random(q.shape) < 0.05] = -3
    gd = torch.from_numpy(g).cuda()
    xp = bcount.pack_bitplanes(gd, W=W, query=False)
    qp = bcount.pack_bitplanes(torch.from_numpy(q).cuda(), W=W, query=True)
    return g, gd, q, xp, qp


def bcount_stats(qp, xp, qf, xf, err: int, plain_reps: int = 5) -> dict:
    """Times of K2, its plain version and F - cdist(p=0) on one input, and
    K2's bound: per (query, row, lane) P XNOR-ANDs, a popcount and an
    add."""
    import torch
    from niqki_tpu_torch.ops import bcount
    ms = time_cuda(lambda: bcount._bcount_call(qp, xp))
    dev_ms = device_ms(lambda: bcount._bcount_call(qp, xp))
    plain_ms = time_cuda(lambda: bcount._bcount_plain(qp, xp),
                         reps=plain_reps, warmup=1)
    library_ms = None if qf is None else time_cuda(
        lambda: cdist_counts(qf, xf), reps=plain_reps, warmup=1)
    P, Qb, L = qp.shape
    Gx = xp.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"shape": f"P={P} Qb={Qb} G={Gx} L={L}", "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "plan": bcount._plan(P, Qb, Gx, L, sms),
            **bound(4 * (P * Qb * L + P * Gx * L + Qb * Gx),
                    Qb * Gx * L * (P + 2))}


def check_bcount(P: int, matrix_rows: tuple = (),
                 F: int = 32768) -> list[dict]:
    """K2 against its plain version over 4096 index rows of F / 32 lanes
    (1024 at S=15): at the -Q shape (96 queries packed from fingerprints,
    as match_counts_planes ships them) and, for each B of ``matrix_rows``,
    with the first B index rows re-encoded as queries: the -M shape at
    B = MATRIX_BLOCK, as the self-join sweep launches it, and the whole -M
    count in one launch at B = 4096."""
    import torch
    from niqki_tpu_torch.ops import bcount
    g, gd, q, xp, qp = bcount_inputs(P, F)
    shapes = [("-Q", q, qp)]
    for B in matrix_rows:
        path = "-M" if B == bcount.MATRIX_BLOCK else f"-M {B} rows"
        shapes.append((path, g[:B], bcount._planes_as_queries(
            xp, 0, B).contiguous()))
    xf = gd.float()
    out = []
    for path, qsrc, qp in shapes:
        got = bcount._bcount_call(qp, xp)
        want = bcount._bcount_plain(qp, xp)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        require(err == 0 and torch.equal(got, want),
                f"K2 differs from its plain version at P={P}, {path} shape")
        require(int(got.max()) > F // 2, "K2 check saw no real matches")
        # a query's invalid slot matches nothing: -3, unlike the stored -2
        qf = torch.from_numpy(np.where(qsrc < 0, -3, qsrc)).cuda().float()
        require(torch.equal(cdist_counts(qf, xf).to(torch.int32), got),
                f"F - cdist(p=0) differs from K2 at P={P}, {path} shape")
        out.append({"path": path, **bcount_stats(qp, xp, qf, xf, err)})
    return out


def check_bcount_rows(tiles: int = 25) -> dict:
    """K2 at 96 queries against 102,400 index rows (a 100k-genome index at
    S=15, P=13), not on the smoke's main path: the 4096-row planes of
    check_bcount repeated ``tiles`` times along rows on the card. The
    counts must equal the plain version's and the 4096-row counts tiled
    ``tiles`` times; F - cdist(p=0) over float copies (13.4 GB) is timed
    beside them where the card's memory allows."""
    import torch
    from niqki_tpu_torch.ops import bcount
    _, gd, q, xp, qp = bcount_inputs(13)
    small = bcount._bcount_call(qp, xp)
    xbig = xp.repeat(1, tiles, 1)
    del xp
    got = bcount._bcount_call(qp, xbig)
    want = bcount._bcount_plain(qp, xbig)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    require(err == 0 and torch.equal(got, want),
            f"K2 differs from its plain version at 96 x {G * tiles} rows")
    require(torch.equal(got, small.repeat(1, tiles)),
            f"K2 at 96 x {G * tiles} rows differs from the 4096-row counts")
    qf = torch.from_numpy(np.where(q < 0, -3, q)).cuda().float()
    try:
        xf = gd.float().repeat(tiles, 1)
        require(torch.equal(cdist_counts(qf, xf).to(torch.int32), got),
                f"F - cdist(p=0) differs from K2 at 96 x {G * tiles} rows")
    except torch.cuda.OutOfMemoryError:
        qf = xf = None
    del gd
    return bcount_stats(qp, xbig, qf, xf, err, plain_reps=3)


def pcount_inputs(Gx: int, S_: int, Qb: int):
    """Qb queries against Gx index rows of F = 2^S_ int16 fingerprints
    (W = 12), pair-packed as SketchIndex._packed ships them. Clusters of 64
    rows, 1% stored -2 slots, 5% query -3 slots; 8 queries are exact copies
    of row 0. Returns (queries, the index padded to TILE_G rows, both on the
    card, and both pair-packed: qd, gd, qp, xp)."""
    import torch
    from niqki_tpu_torch.hostmem import pad_rows
    from niqki_tpu_torch.ops import pcount
    F = 1 << S_
    rng = np.random.default_rng(Gx + S_)
    g = rng.integers(0, 1 << 12, (Gx, F), dtype=np.int16)
    share = rng.integers(0, 2, (Gx, F), dtype=np.int8) == 1
    g[share] = np.repeat(g[::64], 64, axis=0)[:Gx][share]
    g[rng.integers(0, 100, (Gx, F), dtype=np.int8) == 0] = -2
    q = g[rng.choice(Gx, Qb, replace=False)].copy()
    q[rng.integers(0, 20, q.shape, dtype=np.int8) == 0] = -3
    q[:8] = g[0]
    gd = torch.from_numpy(pad_rows(g, pcount.TILE_G)).cuda()
    qd = torch.from_numpy(q).cuda()
    return qd, gd, pcount.pack_rows(qd), pcount.pack_rows(gd)


def check_pcount(Gx: int, S_: int, Qb: int = 64) -> dict:
    """K3 against its plain version: Qb queries against Gx index rows of
    F = 2^S_ (pcount_inputs), the whole count in one _count_call."""
    import torch
    from niqki_tpu_torch.ops import pcount
    F = 1 << S_
    qd, gd, qp, xp = pcount_inputs(Gx, S_, Qb)
    got = pcount._count_call(qp, xp)
    want = pcount._count_plain(qp, xp)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    require(err == 0 and torch.equal(got, want),
            f"K3 differs from its plain version at {Qb} x {Gx}, F={F}")
    require(int(got.max()) == F and int((got > F // 4).sum()) > 8 * 64,
            "K3 check saw no clusters")
    qf, xf = qd.float(), gd.float()
    require(torch.equal(cdist_counts(qf, xf).to(torch.int32), got),
            f"F - cdist(p=0) differs from K3 at {Qb} x {Gx}, F={F}")
    ms = time_cuda(lambda: pcount._count_call(qp, xp))
    dev_ms = device_ms(lambda: pcount._count_call(qp, xp))
    plain_ms = time_cuda(lambda: pcount._count_plain(qp, xp), reps=5,
                         warmup=1)
    library_ms = time_cuda(lambda: cdist_counts(qf, xf), reps=5, warmup=1)
    del qf, xf
    Gp, Fp = xp.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # per (query, row, pair lane), the fewest int32 instructions the card
    # needs (SASS, tools/torch_pcount_ab.py --sass): an xor, one SIMD
    # min.u16x2 that tests both halves, half a three-input add
    return {"shape": f"Qb={Qb} G={Gx} F={F}", "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "plan": pcount._plan(Qb, Gp, Fp, sms),
            **bound(4 * (Qb * Fp + Gp * Fp + Qb * Gp), 2.5 * Qb * Gp * Fp)}


# ---------------------------------------------------------------------------
# phase 4/5 inputs

def write_genomes(d: str) -> tuple[str, list]:
    """G synthetic genomes, one FASTA file each: CLUSTERS random ancestors,
    each expanded into G/CLUSTERS descendants by iid point mutations (the
    replacement base is uniform, the same base included)."""
    rng = np.random.default_rng(SEED)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    per = G // CLUSTERS
    names, seqs = [], []
    for c in range(CLUSTERS):
        anc = rng.choice(alphabet, LEN)
        muts = rng.random((per, LEN)) < MUT
        seqs_c = np.where(muts, rng.choice(alphabet, (per, LEN)), anc[None])
        for i in range(per):
            name = f"c{c}_{c * per + i}.fa"
            with open(os.path.join(d, name), "wb") as f:
                f.write(b">%s\n%s\n" % (name.encode(), seqs_c[i].tobytes()))
            names.append(name)
            seqs.append(seqs_c[i])
    fof = os.path.join(d, "fof.txt")
    with open(fof, "w") as f:
        f.write("".join(n + "\n" for n in names))
    return fof, seqs


def write_queries(d: str, seqs) -> str:
    rng = np.random.default_rng(SEED + 1)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    qd = os.path.join(d, "queries")
    os.makedirs(qd)
    paths = []
    for j, gi in enumerate(sorted(rng.choice(len(seqs), NQ, replace=False))):
        base = seqs[gi]
        m = rng.random(LEN) < QMUT
        s = np.where(m, rng.choice(alphabet, LEN), base)
        path = os.path.join(qd, f"q{j}_of_{gi}.fa")
        with open(path, "wb") as f:
            f.write(b">q%d\n%s\n" % (j, s.tobytes()))
        paths.append(path)
    qfof = os.path.join(d, "qfof.txt")
    with open(qfof, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    return qfof


class Spy:
    """Times and records calls of the port's index methods and engine
    functions during a CLI run (the CLI builds its index internally)."""

    def __init__(self):
        import torch
        from niqki_tpu_torch import engine, index
        self.times: dict[str, float] = {}
        self.index = None
        self.sparse_hits = 0
        cls = index.SketchIndex
        self._orig = [(cls, n, getattr(cls, n)) for n in (
            "sketch_files", "_planes", "_packed", "pretty_hits_batch")]
        self._orig += [(engine, n, getattr(engine, n)) for n in (
            "query_matrix", "_query_matrix_selfjoin")]
        orig = {n: f for _, n, f in self._orig}
        spy = self

        def timed(key, fn):
            def run(*a, **k):
                t = time.time()
                try:
                    return fn(*a, **k)
                finally:
                    spy.times[key] = spy.times.get(key, 0.0) + time.time() - t
            return run

        def sketch_files(self_, paths, *a, **k):
            spy.index = self_
            return timed("ingest_s", orig["sketch_files"])(
                self_, paths, *a, **k)

        def device_copy(name, attr):
            def get(self_):
                if getattr(self_, attr) is not None:
                    return getattr(self_, attr)

                def build():
                    out = orig[name](self_)
                    torch.cuda.synchronize(out.device)  # the device work
                    return out
                return timed(f"{name.strip('_')}_s", build)()
            return get

        def pretty(self_, q, headers):
            buf = orig["pretty_hits_batch"](self_, q, headers)
            spy.sparse_hits += buf is not None
            return buf

        cls.sketch_files = sketch_files
        cls._planes = device_copy("_planes", "_device_planes")
        cls._packed = device_copy("_packed", "_device_packed")
        cls.pretty_hits_batch = pretty
        engine.query_matrix = timed("matrix_s", orig["query_matrix"])
        engine._query_matrix_selfjoin = timed(
            "sweep_s", orig["_query_matrix_selfjoin"])

    def close(self):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def host_index(fof: str, p):
    """The host-native reference index: the port's SketchIndex on the CPU
    under NIQKI_TPU_SKETCH=host, which sketches with the native rolling
    sketcher (independent of the device sketch) and densifies on the
    host."""
    from niqki_tpu_torch import SketchIndex, engine
    os.environ["NIQKI_TPU_SKETCH"] = "host"
    try:
        idx = SketchIndex(p, device="cpu")
        engine.insert_fof_whole(idx, fof)
    finally:
        del os.environ["NIQKI_TPU_SKETCH"]
    return idx


def phase_golden(d: str) -> dict:
    from niqki_tpu_torch import cli, kernels
    os.environ["NIQKI_TPU_MATRIX"] = "selfjoin"
    try:
        kernels.reset_launches()
        out = os.path.join(d, "golden.gz")
        require(cli.main(["-M", os.path.join(FIXDIR, "fof_tiny.txt"), "-S",
                          "16", "-K", "21", "-O", out]) == 0, "golden -M rc")
        launches = dict(kernels.LAUNCHES)
    finally:
        del os.environ["NIQKI_TPU_MATRIX"]
    require(gz_bytes(out) == gz_bytes(os.path.join(
        FIXDIR, "matrix_s16_tiny.gz")), "golden matrix bytes differ")
    return launches


def phase_matrix(d: str, fof: str, spy: "Spy", S_: int, phase: int):
    """-M at full size with -S S_; returns (host reference index,
    launches, index)."""
    import torch
    from niqki_tpu_torch import SketchParams, cli, kernels, native
    p = SketchParams(lF=S_, min_fract=0.05)
    out = os.path.join(d, f"m{S_}.gz")
    os.environ["NIQKI_TPU_MATRIX_STATS"] = "1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spy.times.clear()
    kernels.reset_launches()
    t = time.time()
    rc = cli.main(["-M", fof, "-S", str(S_), "-J", "0.05", "-O", out])
    launches = dict(kernels.LAUNCHES)
    wall = time.time() - t
    del os.environ["NIQKI_TPU_MATRIX_STATS"]
    require(rc == 0, "-M rc")
    idx = spy.index
    require(idx is not None and idx.G == G, "-M did not index G genomes")
    mem = torch.cuda.max_memory_allocated() / 2**30
    tm = {k: round(v, 3) for k, v in spy.times.items()}
    log(f"phase {phase}: -M -S {S_} wall {wall:.2f} s; {tm} (matrix_s: "
        f"query_matrix, which holds sweep_s or the dense loop and the first "
        f"planes_s / packed_s); launches {launches}; peak device memory "
        f"{mem:.2f} GiB")
    t = time.time()
    hidx = host_index(fof, p)
    log(f"phase {phase}: host-native reference sketches in "
        f"{time.time() - t:.1f} s")
    hmat = hidx.matrix()
    require(hidx.names == idx.names, "index names differ")
    require(np.array_equal(idx.matrix(), hmat),
            "device sketches differ from host-native sketches")
    lines = gz_bytes(out).split(b"\n")
    require(len(lines) == G + 2 and lines[-1] == b"",
            "matrix output has the wrong number of rows")
    rng = np.random.default_rng(SEED + 2)
    rows = sorted(rng.choice(G, 96, replace=False))
    fmt = native.MatrixFormatter(hidx.names, p.F, p.min_score)
    counts = native.count_eq(hmat[rows], hidx._stored(), p.fingerprint_range)
    cells = 0
    for r, c in zip(rows, counts):
        want = fmt.format_dense((c & 0xFFFF).astype(np.uint16)[None], r)
        require(lines[1 + r] + b"\n" == want,
                f"matrix row {r} differs from host counts")
        cells += int((c >= p.min_score).sum())
    require(cells > 96, "sampled rows hold no off-diagonal similarity")
    log(f"phase {phase}: sketch matrix == host-native; 96 sampled rows == "
        f"host counts ({cells} cells >= J)")
    return hidx, launches, idx


def phase_query(d: str, fof: str, qfof: str, hidx, spy: "Spy",
                phase: int) -> dict:
    from niqki_tpu_torch import cli, kernels, native
    p = hidx.params
    qout = os.path.join(d, f"q{p.lF}.gz")
    kernels.reset_launches()
    spy.sparse_hits = 0
    t = time.time()
    rc = cli.main(["-I", fof, "-Q", qfof, "-S", str(p.lF), "-J", "0.05",
                   "-O", qout])
    wall = time.time() - t
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, "-I/-Q rc")
    with open(qfof) as f:
        qpaths = [ln.rstrip("\n") for ln in f if ln.strip()]
    hq = host_index(qfof, p)
    fmt = native.HitsFormatter(hidx.names, p.F, p.min_score)
    want = fmt.format(native.count_eq(hq.matrix(), hidx._stored(),
                                      p.fingerprint_range), qpaths)
    got = gz_bytes(qout)
    require(got == want, "-Q hits differ from host-native hits")
    log(f"phase {phase}: -I/-Q -S {p.lF} wall {wall:.2f} s ({NQ} queries, "
        f"{got.count(b':')} hits, {spy.sparse_hits} sparse top-k batches) "
        f"== host-native; launches {launches}")
    return launches


def kernel_entry(name, source, replaces, launches, stats, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, **stats, **extra}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from niqki_tpu_torch import kernels, native

    # ---- phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    t = time.time()
    so = kernels.build()
    kernels.library()
    build_s = time.time() - t
    log(f"phase 1: kernels built in {build_s:.2f} s -> {os.path.relpath(so)}")
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())
    require(native.available(), "native host library did not build")

    # ---- phase 2
    k1 = {B: check_psort(B, n, Np) for B, n, Np in
          ((256, LEN, 1 << 17), (1, 4_600_000, 1 << 23),
           (6, 4_600_000, 1 << 23))}
    for e in k1.values():
        log(f"phase 2: K1 psort {e}")
    k2 = {e["path"]: e for e in check_bcount(13, matrix_rows=(768,))}
    for e in k2.values():
        log(f"phase 2: K2 bcount {e}")
    log(f"phase 2: K2 bcount {check_bcount(17)[0]}")
    k2["rows"] = check_bcount_rows()
    log(f"phase 2: K2 bcount (96 x 102,400 rows) {k2['rows']}")
    for S_ in (10, 11):     # beside K3, which serves S <= 11: measured only
        for e in check_bcount(13, matrix_rows=(768, G), F=1 << S_):
            k2[f"{e['path']} S={S_}"] = e
            log(f"phase 2: K2 bcount (S={S_}) {e}")
    torch.cuda.empty_cache()
    k3 = {key: check_pcount(Gx, S_, Qb) for key, Gx, S_, Qb in
          (("a", G, 10, 64), ("b", 102_400, 10, 64), ("c", G, 11, 64),
           ("d", G, 10, G), ("e", G, 10, NQ), ("f", G, 11, G))}
    for key, e in k3.items():
        log(f"phase 2: K3 pcount ({key}) {e}")

    with tempfile.TemporaryDirectory(prefix="niqki_smoke_") as d:
        # ---- phase 3
        launches = phase_golden(d)
        require(launches["psort"] > 0 and launches["bcount"] > 0,
                f"golden run skipped a kernel: {launches}")
        log(f"phase 3: golden matrix byte-identical, launches {launches}")
        # ---- phases 4 to 7
        t = time.time()
        fof, seqs = write_genomes(d)
        qfof = write_queries(d, seqs)
        log(f"phase 4: wrote {G} genomes of {LEN} bp + {NQ} queries in "
            f"{time.time() - t:.1f} s")
        spy = Spy()
        try:
            hidx, m15, idx = phase_matrix(d, fof, spy, S, 4)
            require(m15["psort"] > 0 and m15["bcount"] > 0,
                    f"-M -S {S} skipped a kernel: {m15}")
            require(idx._device_planes is not None and tuple(
                idx._device_planes.shape) == (13, G, (1 << S) // 32),
                "index planes missing or misshapen")
            q15 = phase_query(d, fof, qfof, hidx, spy, 5)
            require(q15["bcount"] > 0 and spy.sparse_hits > 0,
                    "-Q -S 15 did not take the K2 top-k route")
            hidx, m10, idx = phase_matrix(d, fof, spy, 10, 6)
            require(m10["pcount"] == 1 and m10["bcount"] == 0
                    and m10["psort"] > 0,
                    f"-M -S 10 did not count through one K3 launch: {m10}")
            require(idx._device_packed is not None and tuple(
                idx._device_packed.shape) == (G, 512),
                "pair-packed index missing or misshapen")
            q10 = phase_query(d, fof, qfof, hidx, spy, 7)
            require(q10["pcount"] == 1 and q10["bcount"] == 0
                    and spy.sparse_hits == 0,
                    f"-Q -S 10 did not count through one K3 launch: {q10}")
        finally:
            spy.close()

    k1_src = ("niqki_tpu_torch/csrc/psort.cu", "niqki_tpu/ops/psort.py:125")
    k2_src = ("niqki_tpu_torch/csrc/bcount.cu", "niqki_tpu/ops/bcount.py:103")
    k3_src = ("niqki_tpu_torch/csrc/pcount.cu", "niqki_tpu/ops/pcount.py:52")
    ecoli = "not on the smoke's main path (E. coli-sized records)"
    off_path = ("not on the main path (phase 2 only): the port counts a "
                "whole call in one launch")
    print(json.dumps({"kernels": [
        kernel_entry("psort sort_i32_pow2_batch (K1, 256 x 2^17)", *k1_src,
                     m15["psort"], k1[256],
                     launches_from="phase 4, -M -S 15"),
        kernel_entry("psort sort_i32_pow2_batch (K1, 1 x 2^23)", *k1_src, 0,
                     k1[1], launches_from=ecoli),
        kernel_entry("psort sort_i32_pow2_batch (K1, 6 x 2^23)", *k1_src, 0,
                     k1[6], launches_from=ecoli),
        kernel_entry("bcount _bcount_call (K2, -M shape)", *k2_src,
                     m15["bcount"], k2["-M"],
                     launches_from="phase 4, -M -S 15"),
        kernel_entry("bcount _bcount_call (K2, -Q shape)", *k2_src,
                     q15["bcount"], k2["-Q"],
                     launches_from="phase 5, -I/-Q -S 15"),
        kernel_entry("bcount _bcount_call (K2, 96 x 102,400 rows)", *k2_src,
                     0, k2["rows"],
                     launches_from="not on the main path (phase 2 only)"),
        *[kernel_entry(f"bcount _bcount_call (K2, {path} shape at S={S_}, "
                       f"{k2[f'{path} S={S_}']['shape']})", *k2_src, 0,
                       k2[f"{path} S={S_}"],
                       launches_from="not on the main path (phase 2 only):"
                       " S <= 11 counts through K3")
          for S_ in (10, 11) for path in ("-M", f"-M {G} rows", "-Q")],
        kernel_entry("pcount _count_call (K3, shape a)", *k3_src, 0, k3["a"],
                     launches_from=off_path),
        kernel_entry("pcount _count_call (K3, shape b)", *k3_src, 0, k3["b"],
                     launches_from=off_path),
        kernel_entry("pcount _count_call (K3, shape c)", *k3_src, 0, k3["c"],
                     launches_from=off_path),
        kernel_entry("pcount _count_call (K3, shape d, the -M call)",
                     *k3_src, m10["pcount"], k3["d"],
                     launches_from="phase 6, -M -S 10"),
        kernel_entry("pcount _count_call (K3, shape e, the -Q call)",
                     *k3_src, q10["pcount"], k3["e"],
                     launches_from="phase 7, -I/-Q -S 10"),
        kernel_entry("pcount _count_call (K3, shape f, the -M call at S=11)",
                     *k3_src, 0, k3["f"],
                     launches_from="not on the main path (phase 2 only): "
                     "the smoke's main path runs S=10"),
    ], "build_s": build_s, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
