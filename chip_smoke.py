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
     torch.profiler; K2 (bcount) against 4096 index rows of 1024 lanes
     at the -M shape (768 index rows re-encoded as queries, one
     MATRIX_BLOCK of the full sweep, P = 13), at phase 4's symmetric-sweep
     window (the same queries against 4608 rows of the planes extended by
     never-matching rows, a view read in place) and at the -Q shape (96
     packed queries, P = 13 and 17) and, off the main path, 96 queries
     against 102,400 rows (the 4096-row planes repeated 25 times on the
     card; the counts must also equal the 4096-row counts tiled), and,
     measured beside K3 though S <= 11 does not route to it, at S = 10
     (32 lanes) and S = 11 (64 lanes), P = 13, at the -M and -Q shapes and
     with all 4096 rows as queries in one launch; K3 (pcount) at the whole
     count calls of the main path, (d) 4096 queries against 4096 rows at
     S = 10 (phase 6's -M call) and (e) 96 queries against them (phase 7's
     -Q call), (f) the whole -M call at S = 11, and with 64 queries (the JAX
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
     configuration (K=31, S=15, W=12, H=4) and -J 0.05, through the
     symmetric sweep (NIQKI_TPU_MATRIX_SYM=auto). The sketch matrix must
     equal the host-native sketches, 96 sampled output rows must equal rows
     formatted from host counts, and K1 and K2 must have launched.
  5. -I/-Q: 96 query genomes (1% mutants of index genomes) against that
     index through the K2 top-k route; the output must equal the
     host-native hits.
  6. -M -S 10 -J 0.05 over the same 4096 genomes: the bit-plane gate fails,
     so the dense loop counts through one K3 launch (and launches no K2);
     sketches and 96 sampled rows must equal host-native.
  7. -I/-Q -S 10 -J 0.05 with the same queries: the dense hit route through
     one K3 launch; the output must equal the host-native hits.
  8. lines mode at S=15, -J 0.05: -i of phase 4's 4096 genomes written as
     one multi-FASTA (every record over HOST_SKETCH_MAX, so every record
     sketches through K1 at 2^17), whose matrix must equal phase 4's row for
     row and whose names must be the headers; then -l of 8192 records cut
     from phase 5's mutants (the 96 mutants of 100 kb, K1 at 2^17; 1000
     contigs of 40-65 kb, K1 at 2^16; 7096 contigs of 2-30 kb on the host
     sketcher) through the K2 top-k route, whose output must equal the
     host-native hits (the host sketcher, native.count_eq counts,
     native.HitsFormatter). K1 and K2 must have launched.
  9. dumps: SketchIndex.dump of phase 8's index, then -L of it with -l of
     the same records: the loaded matrix and names must equal phase 8's
     index and the output phase 8's bytes, through K2.
 10. BASELINE config 5: -i/-M of 102,400 genomes of 10 kb (128 clusters of
     800 at 2% point mutation, numpy seed 7, the JAX package's bench input)
     as one multi-FASTA, K=31 S=12 W=12 H=4, -J 0.05, once through the
     symmetric sweep (SYM=auto) and once through the full sweep (SYM=off),
     each with its wall, ingest, planes and sweep times, K2 launches and
     device ms, peak device memory and the sweep's stats (peak mirror
     bytes). The two gzip outputs must have one SHA-256; 128 sampled rows
     (read in one streaming pass) must equal rows formatted from
     native.count_eq counts of host-native sketches; the symmetric sweep's
     K2 columns must be the window widths' share of the full sweep's
     (0.53 +- 0.01) and its peak device memory at most the full sweep's
     plus the padding rows' planes.
 11. adversarial density: 4096 rows at S=12 that all match each other
     (SketchIndex.from_arrays) with a top-k cap of 128, so every row
     overflows: the symmetric sweep's output must equal the full sweep's
     byte for byte, and its peak mirror bytes stay within 10 B for each
     survivor cell beyond its row's block.
 12. checkpoints at G = 4096: the CLI's -I -S 15 --save-sharded --shards 4
     (v2, gzip rows), then --load-sharded -Q of phase 5's queries, must give
     phase 5's bytes; phase 4's index saved through the API as v3 (3 raw
     shards with planes) and loaded must give phase 4's matrix bytes
     through engine.query_matrix, and each planes file must equal the
     card's planes over its rows; phase 6's S=10 index saved and loaded
     must give phase 7's -Q bytes through exactly one K3 launch. Save and
     load seconds and the bytes on disk are printed.
 13. checkpoints at BASELINE config 5: phase 10's index saved with 8
     shards as v3 (raw rows and planes) and as v2 (gzip rows) and loaded:
     matrix and names equal, the planes files equal to the card's planes,
     and K2's counts of 96 of its rows equal on the reloaded index and the
     original. The native plane pack of the whole matrix is timed beside
     phase 10's device plane build.
 14. --profile: phase 5's -I/-Q at S=15 under torch.profiler must give
     phase 5's bytes and a trace that parses as JSON and names K1's and
     K2's kernels; its wall and size are printed beside phase 5's wall.
 15. NIQKI_TPU_COUNT=mxu (the one-hot matrix product, torch code: the JAX
     package has no Pallas kernel for it): 96 queries against 4096 rows at
     S=12, W=12, counts equal to K2's, both timed.
 16. the one-process mesh at G = 4096 on eight virtual devices of the one
     card (NIQKI_TPU_VIRTUAL_DEVICES=8, --mesh 2x4): -M -S 15 must give
     phase 4's bytes through exactly 24 K2 launches (6 blocks x 4 tp
     shards) and 8 K1 launches for each of phase 4's; -I/-Q -S 15 phase
     5's bytes through per-shard top-k (8 K2 launches, one a device);
     -M -S 10 and -I/-Q -S 10 phases 6 and 7's through 8 K3 launches each;
     -i/-l phase 8's bytes; ShardedIndex.from_checkpoint of phase 12's v3
     directory under 1x4 the counts of phase 5's reference; then
     entry.dryrun_multichip(8). K2 and K3 at the per-shard shapes are held
     against their plain versions, against the unsharded call's columns
     and F - cdist(p=0), and timed (device_ms) beside the unsharded call.
 17. BASELINE config 5 under --mesh 1x4 (four virtual devices): phase
     10's -i/-M must give phase 10's SHA-256 through the mesh's full sweep,
     134 blocks x 4 shards = 536 K2 launches; its wall, wait, emit and peak
     device memory are printed. ShardedIndex.from_checkpoint of phase 13's
     v3 and v2 directories under 1x4 must give phase 13's counts of 96
     rows; the load seconds are printed.
 18. the multi-process mesh: two ranks (this script, --phase18-rank) that
     init_distributed over gloo (NCCL takes one process per card), both on
     cuda:0 with four virtual devices each, one global mesh of 8. At
     G = 4096: an ingest at S=15 under 2x4 and at S=10 under 1x8, then
     -M and -I/-Q under 1x8 and 2x4; each rank's bytes must equal phases
     4-7's. Config 5 restarted from phase 13's v3 directory under 1x8
     (each rank reads the planes files of its own shards): phase 13's
     counts of 96 rows, then -M with phase 10's SHA-256, on each rank.
     Each rank's K1/K2/K3 launches per path are checked where the layout
     fixes them, every shard a rank holds goes through K2/K3 and the plain
     version, K1 against torch.sort; each rank's walls, host seconds in
     collectives and peak device memory are printed beside the
     one-process twins' walls. A rank that fails or hangs fails the phase.
 19. the rest of the JAX package's surface: (a) sketch_codes of six random
     4.64 Mbp records (one with runs of N) at S=15, K1 at 1 x 2^23 exactly
     six times, each table equal to native.sketch_codes_cpu and to the
     same keys sorted by torch.sort (K1's plain version); 20 kb
     records at lF=24 and W=30 through the scatter-min equal to the host's;
     dispatch_sketch of a record timed beside K1. (b) all_vs_all_counts of
     phase 4's index (K2: 42 blocks of 96 and one of 64) and of phase 6's
     (one K3 launch): 96 sampled rows equal native.count_eq, the diagonal
     F. (c) phase 13's v3 directory loaded: hits of 8 of phase 13's rows
     equal hits_from_counts of its counts, and
     ShardedIndex.from_checkpoint(ck).hits equals
     SketchIndex.load_sharded(ck).hits for a random query. (d) phase 13's
     96 counts through the reloaded index equal phase 13's (K2 at
     96 x 102,400 x 128 lanes, held against its plain version and
     F - cdist, and timed, as at 1 x 102,400 for hits). (e) phase 6's -M -S 10
     through the API under NIQKI_TPU_GZLEVEL=1 gives phase 6's
     decompressed bytes; native.gzip_member against Python's zlib on 4 MiB
     of config-5 row text at levels 1 and 6, in MB/s, and whether the
     library links libdeflate. (f) insert_file_whole of phase 4's first 32
     files gives their rows of phase 4's matrix (K1 at 2 x 2^17);
     match_counts_bitplane at the -Q shape equals the plain blocked count
     and sort_i32_pow2 at 2^23 equals torch.sort. Phase 19 removes phase
     13's v3 directory.

Phase 2 also checks and times K1 at 512 x 2^16, the lines-mode shape of
phase 8's 40-65 kb contigs, and K2 at two of phase 10's windows (block 0,
768 x 102,912 columns, and block 67, 768 x 55,296 from row 51,456), each a
view of the extended planes that the kernel must read without a copy. The
second line from the end is a JSON object with, for each kernel and
main-path shape, its launches in the run that gives it that shape (phase 4
and 5 at S=15, 6 and 7 at S=10, 8 for K1 at 2^16, 10 for the config-5
window) and in phases 8, 9 and 12 to 14 (launches_phase8, ...; K1 by row
length), its error, times, bound and library time, then phase 13's
checkpoint numbers, phase 14's and phase 15's, 16's, 17's and 18's (K1,
K2 and K3 rows carry launches_phase16, launches_phase17 and, per rank,
launches_phase18, with rows of their own at the per-device and per-shard
shapes; rows on phase 19's paths carry launches_phase19, and phase 19's
numbers follow); the last line names the device. Without a CUDA device, or without the
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
N_MID, N_SHORT = 1000, 8192 - 1000 - 96     # phase 8's -l contigs
G5, LEN5 = 102_400, 10_000      # phase 10: BASELINE config 5
S = 15          # sketch size 2^S; K=31, W=12, H=4 are the CLI defaults
SEED = 7
T0 = time.time()
# The H100 SXM's peaks (NVIDIA's data sheet): 3.35 TB/s of device memory;
# 64 INT32 lanes per SM per clock (Hopper white paper) x 132 SMs x 1.98 GHz,
# the boost clock behind the data sheet's 67 TFLOP/s of float32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
WALLS: dict = {}        # phase -> wall s of phases 4-7's CLI runs


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


def sym_widths(rows: int) -> tuple[int, list, int]:
    """The symmetric sweep's layout of an index of ``rows`` (padded) rows
    at the defaults (MATRIX_BLOCK 768, QB 8): (blocks N, window widths in
    blocks, rows of the extended planes)."""
    from niqki_tpu_torch.ops import bcount
    B, QB = bcount.MATRIX_BLOCK, 8
    N = -(-rows // B)
    widths = [min(N, -(-(N - i) // QB) * QB) for i in range(N)]
    return N, widths, (N + QB - 1) * B


ALLOC_SLACK = 2 << 20   # what torch's caching allocator may add to a block


def k2_in_place(qp, win):
    """K2 of qp against the window view ``win``; the call must allocate its
    output and nothing else (no copy of the window: the allocator may hand
    out a block up to ALLOC_SLACK larger than asked, the window's planes
    are larger still). Returns (counts, the bytes the call allocated)."""
    import torch
    from niqki_tpu_torch.ops import bcount
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = bcount._bcount_call(qp, win)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    require(extra < got.numel() * 4 + ALLOC_SLACK,
            f"K2 copied a window of {tuple(win.shape)}: {extra} bytes")
    return got, extra


def check_bcount(P: int, matrix_rows: tuple = (), F: int = 32768,
                 window: bool = False) -> list[dict]:
    """K2 against its plain version over 4096 index rows of F / 32 lanes
    (1024 at S=15): at the -Q shape (96 queries packed from fingerprints,
    as match_counts_planes ships them) and, for each B of ``matrix_rows``,
    with the first B index rows re-encoded as queries: the full sweep's -M
    block at B = MATRIX_BLOCK and the whole -M count in one launch at
    B = 4096. ``window`` adds the symmetric sweep's -M window at G = 4096,
    as phase 4 launches it: 768 queries against the first 6 x 768 rows of
    the planes extended by never-matching rows, a view read in place."""
    import torch
    from niqki_tpu_torch.ops import bcount
    g, gd, q, xp, qp = bcount_inputs(P, F)
    xf = gd.float()
    shapes = [("-Q", q, qp, xp, xf)]
    for B in matrix_rows:
        path = "-M" if B == bcount.MATRIX_BLOCK else f"-M {B} rows"
        shapes.append((path, g[:B], bcount._planes_as_queries(
            xp, 0, B).contiguous(), xp, xf))
    if window:
        B = bcount.MATRIX_BLOCK
        _, widths, rows = sym_widths(G)
        xpe = bcount.extend_planes(xp, rows - G)
        cols = widths[0] * B
        shapes.append(("-M window", g[:B], bcount._planes_as_queries(
            xpe, 0, B), xpe[:, :cols], torch.cat(
                [xf, xf.new_full((cols - G, F), -2.0)])))
    out = []
    for path, qsrc, qp, x, xf in shapes:
        got, extra = k2_in_place(qp, x)
        want = bcount._bcount_plain(qp, x)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        require(err == 0 and torch.equal(got, want),
                f"K2 differs from its plain version at P={P}, {path} shape")
        require(int(got.max()) > F // 2, "K2 check saw no real matches")
        # a query's invalid slot matches nothing: -3, unlike the stored -2
        qf = torch.from_numpy(np.where(qsrc < 0, -3, qsrc)).cuda().float()
        require(torch.equal(cdist_counts(qf, xf).to(torch.int32), got),
                f"F - cdist(p=0) differs from K2 at P={P}, {path} shape")
        out.append({"path": path, "call_extra_bytes": extra,
                    **bcount_stats(qp, x, qf, xf, err)})
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


def check_bcount_window() -> list[dict]:
    """K2 at the symmetric sweep's config-5 shapes, off the smoke's other
    paths: 102,400 index rows at S=12 (128 lanes, P=13; random
    fingerprints, rows 0-767 equal, 1% stored -2 slots) extended to the
    sweep's 108,288 rows, and block 0's window (768 x 102,912 columns, the
    widest; it runs 512 columns into the padding) and block 67's (768 x
    55,296 from row 51,456, across the index's end), each a view of the
    extended planes read in place. The call must allocate its output and
    nothing else; the counts must equal the plain version on the same view
    and F - cdist(p=0) over float copies of the window's fingerprints
    (padding rows -2, query -3 slots)."""
    import torch
    from niqki_tpu_torch.ops import bcount
    W, F, B = 12, 4096, bcount.MATRIX_BLOCK
    N, widths, rows = sym_widths(G5)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = torch.randint(0, 1 << W, (rows, F), dtype=torch.int16,
                      device="cuda", generator=gen)
    g[:B] = g[0]
    g[torch.rand((rows, F), device="cuda", generator=gen) < 0.01] = -2
    g[G5:] = -2
    xpe = bcount.extend_planes(bcount.pack_bitplanes(g[:G5], W=W,
                                                     query=False),
                               rows - G5)
    require(torch.equal(xpe, bcount.pack_bitplanes(g, W=W, query=False)),
            "extend_planes' padding differs from stored -2 rows")
    out = []
    for i in (0, N // 2):
        lo, cols = i * B, widths[i] * B
        win = xpe[:, lo:lo + cols]
        qp = bcount._planes_as_queries(xpe, lo, B)
        got, extra = k2_in_place(qp, win)
        want = bcount._bcount_plain(qp, win)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        require(err == 0 and torch.equal(got, want),
                f"K2 differs from its plain version on window {i}")
        del want
        require(int(got.max()) > F // 2,
                "K2 window check saw no real matches")
        qs = g[lo:lo + B]
        qf = torch.where(qs < 0, -3, qs).float()
        xf = g[lo:lo + cols].float()
        require(torch.equal(cdist_counts(qf, xf).to(torch.int32), got),
                f"F - cdist(p=0) differs from K2 on window {i}")
        del got
        out.append({"path": f"config-5 window, block {i}",
                    "window": f"rows [{lo}, {lo + cols}) of {rows}",
                    "call_extra_bytes": extra,
                    **bcount_stats(qp, win, qf, xf, err, plain_reps=3)})
        del qf, xf
    return out


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
    return pcount_stats(*pcount_inputs(Gx, S_, Qb), Gx)


def pcount_stats(qd, gd, qp, xp, Gx: int, whole=None) -> dict:
    """K3 of the pair-packed queries qp against the pair-packed rows xp
    (their int16 fingerprints qd, gd) against its plain version and
    F - cdist(p=0), exactly, then timed: ms, device_ms, plain and library
    ms, the launch plan and the bound. ``whole``: the counts of an
    unsharded call whose columns these counts must equal."""
    import torch
    from niqki_tpu_torch.ops import pcount
    Qb, F = qd.shape
    got = pcount._count_call(qp, xp)
    want = pcount._count_plain(qp, xp)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    require(err == 0 and torch.equal(got, want),
            f"K3 differs from its plain version at {Qb} x {Gx}, F={F}")
    require(whole is None or torch.equal(got, whole),
            f"K3 per shard at {Qb} x {Gx} differs from the unsharded call")
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
    paths, mutants = [], []
    for j, gi in enumerate(sorted(rng.choice(len(seqs), NQ, replace=False))):
        base = seqs[gi]
        m = rng.random(LEN) < QMUT
        s = np.where(m, rng.choice(alphabet, LEN), base)
        path = os.path.join(qd, f"q{j}_of_{gi}.fa")
        with open(path, "wb") as f:
            f.write(b">q%d\n%s\n" % (j, s.tobytes()))
        paths.append(path)
        mutants.append((f"q{j}_of_{gi}", s))
    qfof = os.path.join(d, "qfof.txt")
    with open(qfof, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    return qfof, mutants


def write_lines_inputs(d: str, fof: str, seqs, mutants) -> tuple[str, str]:
    """Phase 8's inputs: the G genomes as one multi-FASTA (the records of
    phase 4's files, in fof order), and a query file of the NQ mutants,
    N_MID contigs of 40-65 kb and N_SHORT contigs of 2-30 kb cut from the
    mutants at random, in a random order."""
    with open(fof) as f:
        names = [ln.rstrip("\n") for ln in f]
    allfa = os.path.join(d, "all.fa")
    with open(allfa, "wb") as f:
        for name, s in zip(names, seqs):
            f.write(b">%s\n%s\n" % (name.encode(), s.tobytes()))
    rng = np.random.default_rng(SEED + 3)
    recs = [(name, s) for name, s in mutants]
    for k, (lo, hi) in enumerate([(40_000, 65_000)] * N_MID
                                 + [(2_000, 30_000)] * N_SHORT):
        j = int(rng.integers(len(mutants)))
        n = int(rng.integers(lo, hi + 1))
        st = int(rng.integers(0, LEN - n + 1))
        recs.append((f"contig{k}_{mutants[j][0]}_{st}_{n}",
                     mutants[j][1][st:st + n]))
    qfa = os.path.join(d, "lines_q.fa")
    with open(qfa, "wb") as f:
        for i in rng.permutation(len(recs)):
            name, s = recs[i]
            f.write(b">%s\n%s\n" % (name.encode(), s.tobytes()))
    return allfa, qfa


class Spy:
    """Times and records calls of the port's index methods and engine
    functions during a CLI run (the CLI builds its index internally), the
    row length of every K1 call (``k1_rows``: N -> calls), every K2 call's
    (queries, columns) with CUDA events around it (``k2``; ``k2_summary``),
    the launches of each kernel at each shape (``shapes``: (kernel, shape)
    -> launches, the shape written as the phase-2 checks write it) and the
    stats the symmetric and mesh sweeps return (``sym_stats``,
    ``mesh_stats``)."""

    def __init__(self):
        import torch
        from niqki_tpu_torch import engine, index, kernels
        from niqki_tpu_torch.ops import bcount, pcount, psort, sketch
        self.times: dict[str, float] = {}
        self.index = None
        self.sparse_hits = 0
        self.k1_rows: dict[int, int] = {}
        self.k2: list = []
        self.shapes: dict[tuple, int] = {}
        self.sym_stats = None
        self.mesh_stats = None
        cls = index.SketchIndex
        self._orig = [(cls, n, vars(cls)[n]) for n in (
            "sketch_files", "insert_file_lines", "load", "load_sharded",
            "save_sharded", "_planes", "_packed", "pretty_hits_batch")]
        self._orig += [(engine, n, vars(engine)[n]) for n in (
            "query_matrix", "_query_matrix_selfjoin", "query_file_lines")]
        self._orig.append((sketch, "sort_i32_pow2_batch",
                           sketch.sort_i32_pow2_batch))
        self._orig.append((psort, "sort_i32_pow2_batch",
                           psort.sort_i32_pow2_batch))
        self._orig.append((bcount, "_bcount_call", bcount._bcount_call))
        self._orig.append((pcount, "_count_call", pcount._count_call))
        self._orig.append((engine, "_query_matrix_selfjoin_sym",
                           engine._query_matrix_selfjoin_sym))
        self._orig.append((engine, "_query_matrix_selfjoin_mesh",
                           engine._query_matrix_selfjoin_mesh))
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

        def insert_file_lines(self_, path, *a, **k):
            spy.index = self_
            return timed("ingest_s", orig["insert_file_lines"])(
                self_, path, *a, **k)

        def load(cls_, path, *a, **k):
            spy.index = timed("load_s", orig["load"].__func__)(
                cls_, path, *a, **k)
            return spy.index

        def load_sharded(cls_, path, *a, **k):
            spy.index = timed("load_sharded_s",
                              orig["load_sharded"].__func__)(cls_, path, *a,
                                                             **k)
            return spy.index

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

        def launched(kernel, shape, fn, *a):
            # one count per launch the wrapper itself counts
            n = kernels.LAUNCHES[kernel]
            out = fn(*a)
            if kernels.LAUNCHES[kernel] > n:
                key = (kernel, shape)
                spy.shapes[key] = spy.shapes.get(key, 0) + (
                    kernels.LAUNCHES[kernel] - n)
            return out

        def sort(x):
            n = int(x.shape[1])
            spy.k1_rows[n] = spy.k1_rows.get(n, 0) + 1
            return launched("psort", f"{x.shape[0]}x{n}",
                            orig["sort_i32_pow2_batch"], x)

        def k2(qp, xp):
            if qp.device.type != "cuda":
                return orig["_bcount_call"](qp, xp)
            P, Qb, L = qp.shape
            shape = f"P={P} Qb={Qb} G={xp.shape[1]} L={L}"
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = launched("bcount", shape, orig["_bcount_call"], qp, xp)
            b.record()
            spy.k2.append((int(qp.shape[1]), int(xp.shape[1]), a, b))
            return out

        def k3(qp, xp):
            return launched(
                "pcount", f"Qb={qp.shape[0]} G={xp.shape[0]} "
                f"F={2 * xp.shape[1]}", orig["_count_call"], qp, xp)

        def sym(index_, out_):
            spy.sym_stats = orig["_query_matrix_selfjoin_sym"](index_, out_)
            return spy.sym_stats

        def mesh_sweep(index_, out_, mesh_):
            spy.mesh_stats = orig["_query_matrix_selfjoin_mesh"](
                index_, out_, mesh_)
            return spy.mesh_stats

        cls.sketch_files = sketch_files
        cls.insert_file_lines = insert_file_lines
        cls.load = classmethod(load)
        cls.load_sharded = classmethod(load_sharded)
        cls.save_sharded = timed("save_sharded_s", orig["save_sharded"])
        cls._planes = device_copy("_planes", "_device_planes")
        cls._packed = device_copy("_packed", "_device_packed")
        cls.pretty_hits_batch = pretty
        engine.query_matrix = timed("matrix_s", orig["query_matrix"])
        engine._query_matrix_selfjoin = timed(
            "sweep_s", orig["_query_matrix_selfjoin"])
        engine.query_file_lines = timed("lines_s", orig["query_file_lines"])
        sketch.sort_i32_pow2_batch = sort
        psort.sort_i32_pow2_batch = sort
        bcount._bcount_call = k2
        pcount._count_call = k3
        engine._query_matrix_selfjoin_sym = sym
        engine._query_matrix_selfjoin_mesh = mesh_sweep

    def reset(self):
        self.times.clear()
        self.index = None
        self.sparse_hits = 0
        self.k1_rows.clear()
        self.k2.clear()
        self.shapes.clear()
        self.sym_stats = None
        self.mesh_stats = None

    def k2_summary(self) -> dict:
        """K2 calls since the last reset: launches, device ms summed over
        them (CUDA events around each call, so a gap between the first
        event and the launch counts too), and the (query, column) cells
        counted and the columns of the calls with MATRIX_BLOCK queries (the
        sweep's blocks, the 96-row re-fetches left out)."""
        import torch
        from niqki_tpu_torch.ops import bcount
        torch.cuda.synchronize()
        return {"launches": len(self.k2),
                "device_ms": sum(a.elapsed_time(b) for *_, a, b in self.k2),
                "cells": sum(q * c for q, c, *_ in self.k2),
                "block_columns": sum(c for q, c, *_ in self.k2
                                     if q == bcount.MATRIX_BLOCK)}

    def close(self):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def spied_shapes(spy: "Spy", launches: dict) -> dict:
    """The spy's launches by (kernel, shape) since its last reset, checked
    to add up to ``launches``, the wrappers' own counts."""
    shapes = dict(spy.shapes)
    for k, n in launches.items():
        seen = sum(v for (kk, _), v in shapes.items() if kk == k)
        require(seen == n, f"the spy saw {seen} {k} launches of {n}")
    return shapes


def add_shapes(total: dict, part: dict) -> dict:
    for key, n in part.items():
        total[key] = total.get(key, 0) + n
    return total


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spy.times.clear()
    kernels.reset_launches()
    t = time.time()
    rc = cli.main(["-M", fof, "-S", str(S_), "-J", "0.05", "-O", out])
    launches = dict(kernels.LAUNCHES)
    wall = time.time() - t
    WALLS[phase] = wall
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
                phase: int) -> tuple[dict, float, dict]:
    """-I/-Q of the NQ queries; returns (launches, wall s, the host-native
    reference: query sketches ``q`` and their counts)."""
    from niqki_tpu_torch import cli, kernels, native
    p = hidx.params
    qout = os.path.join(d, f"q{p.lF}.gz")
    kernels.reset_launches()
    spy.sparse_hits = 0
    t = time.time()
    rc = cli.main(["-I", fof, "-Q", qfof, "-S", str(p.lF), "-J", "0.05",
                   "-O", qout])
    wall = time.time() - t
    WALLS[phase] = wall
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, "-I/-Q rc")
    with open(qfof) as f:
        qpaths = [ln.rstrip("\n") for ln in f if ln.strip()]
    hq = host_index(qfof, p)
    fmt = native.HitsFormatter(hidx.names, p.F, p.min_score)
    ref = {"q": hq.matrix(), "counts": native.count_eq(
        hq.matrix(), hidx._stored(), p.fingerprint_range)}
    want = fmt.format(ref["counts"], qpaths)
    got = gz_bytes(qout)
    require(got == want, "-Q hits differ from host-native hits")
    log(f"phase {phase}: -I/-Q -S {p.lF} wall {wall:.2f} s ({NQ} queries, "
        f"{got.count(b':')} hits, {spy.sparse_hits} sparse top-k batches) "
        f"== host-native; launches {launches}")
    return launches, wall, ref


def host_lines_hits(qfa: str, hidx, names) -> bytes:
    """The host-native reference of -l against an index holding hidx's
    matrix under ``names``: every record sketched on the host (the port's
    SketchIndex on the CPU under NIQKI_TPU_SKETCH=host), counted by
    native.count_eq and formatted by native.HitsFormatter."""
    from niqki_tpu_torch import SketchIndex, native
    p = hidx.params
    fmt = native.HitsFormatter(names, p.F, p.min_score)
    stored = hidx._stored()
    parts = []
    os.environ["NIQKI_TPU_SKETCH"] = "host"
    try:
        hq = SketchIndex(p, device="cpu")
        for part, q in hq.query_sketch_stream(
                hq._iter_packed_with_headers(qfa)):
            counts = native.count_eq(q, stored, p.fingerprint_range)
            parts.append(fmt.format(counts, [r[0] for r in part]))
    finally:
        del os.environ["NIQKI_TPU_SKETCH"]
    return b"".join(parts)


def phase_lines(d: str, allfa: str, qfa: str, hidx, spy: "Spy"):
    """Phase 8: -i of the G genomes as one multi-FASTA, then -l of the
    query records; returns (launches, K1 calls by row length, the -i
    index, the -l output bytes)."""
    from niqki_tpu_torch import cli, kernels
    out = os.path.join(d, "lines.gz")
    spy.reset()
    kernels.reset_launches()
    t = time.time()
    rc = cli.main(["-i", allfa, "-l", qfa, "-J", "0.05", "-O", out])
    launches = dict(kernels.LAUNCHES)
    wall = time.time() - t
    require(rc == 0, "-i/-l rc")
    idx, rows, sparse = spy.index, dict(spy.k1_rows), spy.sparse_hits
    tm = {k: round(v, 3) for k, v in spy.times.items()}
    require(sum(rows.values()) == launches["psort"],
            f"K1 calls by row length {rows} != launches {launches}")
    names = [">" + n for n in hidx.names]
    require(idx is not None and idx.names == names,
            "-i names are not the records' headers")
    require(np.array_equal(idx.matrix(), hidx.matrix()),
            "-i matrix differs from phase 4's matrix")
    got = gz_bytes(out)
    log(f"phase 8: -i/-l -S {S} wall {wall:.2f} s; {tm} (ingest_s: -i, "
        f"lines_s: -l); launches {launches}; K1 calls by row length {rows}; "
        f"{sparse} sparse top-k batches; {got.count(b':')} hits")
    t = time.time()
    want = host_lines_hits(qfa, hidx, names)
    log(f"phase 8: host-native -l reference in {time.time() - t:.1f} s")
    require(got == want, "-l hits differ from host-native hits")
    require(launches["psort"] > 0 and launches["bcount"] > 0 and sparse > 0,
            f"-i/-l skipped K1 or the K2 top-k route: {launches}")
    log(f"phase 8: -i matrix == phase 4's, names == headers, -l output == "
        f"host-native ({len(got)} bytes)")
    return launches, rows, idx, got


def phase_dump(d: str, idx, qfa: str, want: bytes, spy: "Spy"):
    """Phase 9: dump phase 8's index, then -L it with -l of the same
    records; returns (launches, K1 calls by row length)."""
    from niqki_tpu_torch import cli, kernels
    dump = os.path.join(d, "index.bin")
    t = time.time()
    idx.dump(dump)
    dump_s = time.time() - t
    size = os.path.getsize(dump)
    out = os.path.join(d, "lines_loaded.gz")
    spy.reset()
    kernels.reset_launches()
    t = time.time()
    rc = cli.main(["-L", dump, "-l", qfa, "-O", out])
    launches = dict(kernels.LAUNCHES)
    wall = time.time() - t
    require(rc == 0, "-L/-l rc")
    loaded, rows = spy.index, dict(spy.k1_rows)
    tm = {k: round(v, 3) for k, v in spy.times.items()}
    require(loaded is not None and loaded.names == idx.names,
            "loaded names differ")
    require(np.array_equal(loaded.matrix(), idx.matrix()),
            "loaded matrix differs from the dumped index")
    require(gz_bytes(out) == want, "-L -l output differs from phase 8's")
    require(launches["bcount"] > 0, f"-L -l skipped K2: {launches}")
    log(f"phase 9: dump_s {dump_s:.2f}, dump {size} bytes; -L/-l wall "
        f"{wall:.2f} s; {tm} (load_s: SketchIndex.load, lines_s: -l); "
        f"launches {launches}; K1 calls by row length {rows}; loaded "
        f"index == phase 8's, -l output == phase 8's")
    return launches, rows


# ---------------------------------------------------------------------------
# phases 10 and 11: the symmetric sweep

def write_config5(d: str) -> str:
    """BASELINE config 5's genomes, as the JAX package's bench makes them
    (bench_scale._synth_clustered_file(102400, 10_000, 128)): CLUSTERS
    random ancestors of LEN5 bases (numpy seed 7), each expanded into
    G5 / CLUSTERS descendants by iid point mutations at MUT (the
    replacement base uniform, the same base included), written in cluster
    order as one multi-FASTA with headers c<cluster>_<gid>."""
    rng = np.random.default_rng(SEED)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    path = os.path.join(d, "config5.fa")
    gid = 0
    with open(path, "wb") as f:
        for c in range(CLUSTERS):
            anc = rng.choice(alphabet, LEN5)
            k = G5 // CLUSTERS + (1 if c < G5 % CLUSTERS else 0)
            muts = rng.random((k, LEN5)) < MUT
            vals = rng.choice(alphabet, (k, LEN5))
            seqs = np.where(muts, vals, anc[None, :])
            for i in range(k):
                f.write(b">c%d_%d\n%s\n" % (c, gid, seqs[i].tobytes()))
                gid += 1
    return path


def sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


def gz_lines(path: str, wanted) -> tuple[dict, int]:
    """The lines of a gzip text file at the 0-based indices in ``wanted``
    (without their newline) and the number of lines, from one streaming
    pass: the text is never held whole. The file must end in a newline."""
    wanted = set(wanted)
    got, line, carry = {}, 0, b""
    with gzip.open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            first = chunk.find(b"\n")
            if first < 0:
                carry += chunk
                continue
            if line in wanted:
                got[line] = carry + chunk[:first]
            last = chunk.rfind(b"\n")
            mid = chunk.count(b"\n", first + 1, last + 1)
            if any(line < w <= line + mid for w in wanted):
                for k, text in enumerate(chunk[first + 1:last].split(b"\n"),
                                         start=line + 1):
                    if k in wanted:
                        got[k] = text
            line += 1 + mid
            carry = chunk[last + 1:]
    require(carry == b"", f"{path} does not end in a newline")
    return got, line


def first_diff_line(a: str, b: str):
    """(line index, its first 200 bytes in a, in b) of the first line where
    two gzip text files differ, streamed; None where they are equal."""
    line = 0
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        while True:
            ca, cb = fa.read(1 << 24), fb.read(1 << 24)
            if ca != cb:
                n = min(len(ca), len(cb))
                neq = np.frombuffer(ca[:n], np.uint8) != \
                    np.frombuffer(cb[:n], np.uint8)
                i = int(np.argmax(neq)) if neq.any() else n
                s = ca.rfind(b"\n", 0, i) + 1
                return (line + ca.count(b"\n", 0, i), ca[s:s + 200],
                        cb[s:s + 200])
            if not ca:
                return None
            line += ca.count(b"\n")


def run_config5(d: str, fa: str, spy: "Spy", sym: str) -> tuple[dict, object]:
    """One -i/-M run of config 5 under NIQKI_TPU_MATRIX_SYM=sym, with what
    phase 10 prints of it; returns (its numbers, its index)."""
    import gc
    import torch
    from niqki_tpu_torch import cli, kernels
    from niqki_tpu_torch.ops import bcount
    out = os.path.join(d, f"config5_{sym}.gz")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    os.environ["NIQKI_TPU_MATRIX_SYM"] = sym
    spy.reset()
    kernels.reset_launches()
    t = time.time()
    try:
        rc = cli.main(["-i", fa, "-M", fa, "-S", "12", "-J", "0.05",
                       "-O", out])
        launches = dict(kernels.LAUNCHES)
    finally:
        del os.environ["NIQKI_TPU_MATRIX_SYM"]
    wall = time.time() - t
    require(rc == 0, f"config 5 -M rc under SYM={sym}")
    idx = spy.index
    require(idx is not None and idx.G == G5,
            f"config 5 did not index {G5} genomes")
    k2 = spy.k2_summary()
    require(k2["launches"] == launches["bcount"] > 0,
            f"config 5 under SYM={sym} skipped K2: {launches}")
    res = {"sym": sym, "out": out, "wall_s": wall,
           "times": {k: round(v, 3) for k, v in spy.times.items()},
           "launches": launches, "k2": k2,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
           "base_device_gib": base / 2**30,
           "stats": spy.sym_stats, "sha256": sha256(out),
           "gz_bytes": os.path.getsize(out)}
    st = spy.sym_stats
    log(f"phase 10: SYM={sym} wall {wall:.2f} s; {res['times']} (ingest_s: "
        f"-i, planes_s: the bit-planes, sweep_s: the sweep); launches "
        f"{launches}; K2 {k2['launches']} launches, {k2['device_ms']:.1f} "
        f"device ms, {k2['cells']} cells, {k2['block_columns']} columns in "
        f"{bcount.MATRIX_BLOCK}-row blocks; peak device memory "
        f"{res['peak_device_gib']:.3f} GiB (at start "
        f"{res['base_device_gib']:.3f}); sweep stats {st}; peak mirror "
        f"bytes {st['peak_mirror_bytes'] if st else 'n/a (full sweep)'}; "
        f"output {res['gz_bytes']} bytes of gzip, sha256 {res['sha256']}")
    return res, idx


def sample_rows(N: int, B: int, n: int = 128) -> list[int]:
    """n rows of a G5-row matrix swept in N blocks of B: the first and last
    block's first rows, last rows and block boundaries, the rest random."""
    rows = {0, 1, B - 1, G5 - 1, G5 - 2, (N - 1) * B, (N - 1) * B + 1}
    for blk in (1, 2, N // 2, N // 2 + 1, N - 1):
        rows |= {blk * B - 1, blk * B}
    rng = np.random.default_rng(SEED + 10)
    while len(rows) < n:
        rows.add(int(rng.integers(G5)))
    return sorted(rows)


def phase_config5(d: str, spy: "Spy") -> dict:
    """Phase 10: BASELINE config 5 (G5 genomes of LEN5 bases, K=31 S=12
    W=12 H=4, -J 0.05) through -i/-M, once under NIQKI_TPU_MATRIX_SYM=auto
    (the symmetric sweep) and once under off (the full sweep). The two
    outputs must have one SHA-256; 128 sampled rows of the symmetric one
    must equal rows formatted from native.count_eq counts of host-native
    sketches; the symmetric sweep's K2 cells must be the widths' share of
    the full sweep's, and its peak device memory at most the full sweep's
    plus the padding rows' planes."""
    from niqki_tpu_torch import SketchIndex, SketchParams, native
    from niqki_tpu_torch.ops import bcount
    t = time.time()
    fa = write_config5(d)
    log(f"phase 10: wrote {G5} genomes of {LEN5} bp ({CLUSTERS} clusters) "
        f"as one multi-FASTA in {time.time() - t:.1f} s")
    sym, idx = run_config5(d, fa, spy, "auto")
    require(sym["stats"] is not None, "SYM=auto did not take the "
            "symmetric sweep")
    idx._device_planes = None          # the card holds one run at a time
    full, idx_full = run_config5(d, fa, spy, "off")
    require(full["stats"] is None, "SYM=off took the symmetric sweep")
    if sym["sha256"] != full["sha256"]:
        diff = first_diff_line(sym["out"], full["out"])
        raise RuntimeError(f"check failed: config 5 outputs differ; first "
                           f"differing line (index, sym, full): {diff}")
    N, widths, rows_ext = sym_widths(G5)
    B = bcount.MATRIX_BLOCK
    want_ratio = sum(widths) * B / (N * G5)
    ratio = sym["k2"]["block_columns"] / full["k2"]["block_columns"]
    cell_ratio = sym["k2"]["cells"] / full["k2"]["cells"]
    require(abs(ratio - 0.53) <= 0.01 and abs(ratio - want_ratio) < 1e-12,
            f"symmetric K2 columns are {ratio:.4f} of the full sweep's, the "
            f"widths give {want_ratio:.4f}")
    require(sym["stats"]["window_cols"] == sum(widths) * B
            and sym["stats"]["N"] == N, f"sweep stats {sym['stats']}")
    pad = 13 * (rows_ext - G5) * 128 * 4
    require(sym["peak_device_gib"] * 2**30
            <= full["peak_device_gib"] * 2**30 + pad,
            "the symmetric sweep's peak device memory passes the full "
            "sweep's plus the padding planes")
    t = time.time()
    p = SketchParams(lF=12, min_fract=0.05)
    os.environ["NIQKI_TPU_SKETCH"] = "host"
    try:
        hidx = SketchIndex(p, device="cpu")
        hidx.insert_file_lines(fa)
    finally:
        del os.environ["NIQKI_TPU_SKETCH"]
    hmat = hidx.matrix()
    require(hidx.names == idx.names and np.array_equal(idx.matrix(), hmat),
            "config 5 sketches differ from host-native sketches")
    del idx
    rows = sample_rows(N, B)
    counts = native.count_eq(hmat[rows], hidx._stored(), p.fingerprint_range)
    fmt = native.MatrixFormatter(hidx.names, p.F, p.min_score)
    ref_s = time.time() - t
    t = time.time()
    got, n_lines = gz_lines(sym["out"], [1 + r for r in rows])
    read_s = time.time() - t
    require(n_lines == G5 + 1, f"config 5 output has {n_lines} lines")
    cells = 0
    for r, c in zip(rows, counts):
        want = fmt.format_dense((c & 0xFFFF).astype(np.uint16)[None], r)
        require(got[1 + r] + b"\n" == want,
                f"config 5 row {r} differs from host counts")
        cells += int((c >= p.min_score).sum())
    require(cells > 10 * len(rows), "config 5's sampled rows hold no "
            "similarity beyond themselves")
    log(f"phase 10: the two sweeps' gzip outputs have one SHA-256; sketches "
        f"== host-native; {len(rows)} sampled rows == host counts ({cells} "
        f"cells >= J; reference {ref_s:.1f} s, streaming read {read_s:.1f} "
        f"s); K2 columns symmetric / full = {ratio:.4f} (widths "
        f"{want_ratio:.4f}; cells {cell_ratio:.4f}); peak device memory "
        f"{sym['peak_device_gib']:.3f} vs {full['peak_device_gib']:.3f} GiB "
        f"(+ padding planes "
        f"{pad / 2**20:.1f} MiB allowed)")
    for res in (sym, full):
        os.remove(res["out"])
    return {"sym": sym, "full": full, "ratio": ratio, "fa": fa,
            "cell_ratio": cell_ratio, "want_ratio": want_ratio,
            "index": idx_full}


def phase_dense_overflow(d: str, spy: "Spy") -> dict:
    """Phase 11: adversarial density. G rows at S=12 (SketchIndex.from_arrays
    on the card) that all share 40% of their slots with one ancestor, so
    every pair survives -J 0.05, and NIQKI_TPU_MATRIX_CAP=128 below every
    row's survivors in its window: every row overflows, is re-counted dense
    and mirrors all its survivors beyond its block. The symmetric sweep's
    output must equal the full sweep's byte for byte and 32 sampled rows
    the plain K2 counts; its mirror entries must be the survivor cells at
    or beyond each row's block end (from those counts) and its peak mirror
    bytes at most 10 B an entry of them."""
    import torch
    from niqki_tpu_torch import SketchIndex, SketchParams, engine, kernels
    from niqki_tpu_torch import native
    from niqki_tpu_torch.io.writers import GzTextWriter
    from niqki_tpu_torch.ops import bcount
    p = SketchParams(lF=12, min_fract=0.05)
    rng = np.random.default_rng(SEED + 11)
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    share = rng.random((G, p.F)) < 0.4
    anc = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
    mat[share] = np.broadcast_to(anc, mat.shape)[share]
    names = [f"d{i}" for i in range(G)]
    res = {}
    os.environ["NIQKI_TPU_MATRIX_CAP"] = "128"
    try:
        for sym in ("on", "off"):
            os.environ["NIQKI_TPU_MATRIX_SYM"] = sym
            idx = SketchIndex.from_arrays(p, names, mat)
            out = os.path.join(d, f"dense_{sym}.gz")
            spy.reset()
            kernels.reset_launches()
            t = time.time()
            with GzTextWriter(out) as w:
                engine.query_matrix(idx, w)
            res[sym] = {"wall_s": time.time() - t,
                        "launches": dict(kernels.LAUNCHES),
                        "k2": spy.k2_summary(), "stats": spy.sym_stats,
                        "out": out}
            require(res[sym]["launches"]["bcount"] > 0,
                    f"phase 11 under SYM={sym} skipped K2")
    finally:
        del os.environ["NIQKI_TPU_MATRIX_CAP"]
        del os.environ["NIQKI_TPU_MATRIX_SYM"]
    text = gz_bytes(res["on"]["out"])
    require(text == gz_bytes(res["off"]["out"]),
            "phase 11: the symmetric sweep's output differs from the full "
            "sweep's")
    xp = bcount.build_index_planes(idx._stored(), p.W, "cuda",
                                   sanitized=True)
    c = (bcount._bcount_plain(bcount._planes_as_queries(xp, 0, G), xp)
         & 0xFFFF).cpu().numpy()
    del xp
    B = bcount.MATRIX_BLOCK
    surv = c >= p.min_score
    require(surv.all(), "phase 11: not every pair survives")
    rows = np.arange(G)[:, None]
    beyond = int((surv & (np.arange(G)[None, :] >= (rows // B + 1) * B))
                 .sum())
    st = res["on"]["stats"]
    require(st is not None and st["mirror_entries"] == beyond,
            f"phase 11: {st and st['mirror_entries']} mirror entries, "
            f"{beyond} survivor cells beyond their block")
    require(st["refetch"] == sum(-(-min(B, G - lo) // 96)
                                 for lo in range(0, G, B)),
            f"phase 11: not every row was re-counted dense: {st}")
    require(0 < st["peak_mirror_bytes"] <= 10 * beyond,
            f"phase 11: peak mirror bytes {st['peak_mirror_bytes']} pass "
            f"10 x {beyond}")
    lines = text.split(b"\n")
    fmt = native.MatrixFormatter(names, p.F, p.min_score)
    for r in np.random.default_rng(SEED + 12).choice(G, 32, replace=False):
        want = fmt.format_dense(c[r:r + 1, :G].astype(np.uint16), int(r))
        require(lines[1 + r] + b"\n" == want,
                f"phase 11 row {r} differs from the plain K2 counts")
    log(f"phase 11: G={G}, every pair survives, cap 128: symmetric output "
        f"== full sweep's ({len(text)} bytes) and 32 sampled rows == plain "
        f"counts; SYM=on {res['on']['wall_s']:.2f} s, K2 "
        f"{res['on']['k2']['launches']} launches "
        f"{res['on']['k2']['device_ms']:.1f} device ms; off "
        f"{res['off']['wall_s']:.2f} s, K2 {res['off']['k2']['launches']} "
        f"launches {res['off']['k2']['device_ms']:.1f} device ms; peak mirror "
        f"bytes {st['peak_mirror_bytes']} <= bound {10 * beyond} "
        f"(10 B x {beyond} survivor cells beyond their block); stats {st}")
    return res


# ---------------------------------------------------------------------------
# phases 12 to 15: checkpoints, --profile and the mxu route

def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def planes_files_match(ck: str, dev_planes, W: int) -> int:
    """Each planes_%05d.bin of the checkpoint ``ck`` must hold the bits of
    the card's planes over its rows [lo, hi) (copied back one shard at a
    time); returns the planes' bytes compared."""
    with open(os.path.join(ck, "manifest.json")) as f:
        shards = json.load(f)["shards"]
    L = dev_planes.shape[2]
    n = 0
    for sh in shards:
        lo, hi = sh["lo"], sh["hi"]
        disk = np.fromfile(os.path.join(ck, sh["planes"]), np.uint32)
        want = dev_planes[:, lo:hi].cpu().numpy().view(np.uint32)
        require(disk.size == (W + 1) * (hi - lo) * L and np.array_equal(
            disk.reshape(W + 1, hi - lo, L), want),
            f"{sh['planes']} differs from the card's planes [:, {lo}:{hi}]")
        n += disk.nbytes
    return n


def phase_checkpoints(d: str, fof: str, qfof: str, idx15, idx10,
                      spy: "Spy") -> dict:
    """Phase 12: checkpoints at G = 4096. (a) The CLI's -I of phase 4's fof
    at S=15 with --save-sharded --shards 4 (v2, compressed), then
    --load-sharded with -Q of phase 5's queries: phase 5's bytes. (b) Phase
    4's index saved through the API as v3 (3 raw shards with planes),
    loaded, and its matrix through engine.query_matrix: phase 4's bytes;
    each planes file equals the card's planes over its rows. (c) Phase 6's
    S=10 index saved (v2, 2 shards), then --load-sharded -Q: phase 7's
    bytes through exactly one K3 launch. Returns the launches of (a)'s and
    (c)'s -Q runs and (b)'s directory (``ck_v3``), kept for phase 16."""
    import shutil
    from niqki_tpu_torch import SketchIndex, cli, engine, kernels
    from niqki_tpu_torch.io.writers import GzTextWriter
    res = {}
    # (a)
    ck = os.path.join(d, "ck_cli")
    spy.reset()
    t = time.time()
    require(cli.main(["-I", fof, "-S", str(S), "-J", "0.05",
                      "--save-sharded", ck, "--shards", "4",
                      "-O", os.path.join(d, "ck_i.gz")]) == 0,
            "-I --save-sharded rc")
    wall_save = time.time() - t
    save_s, size = spy.times["save_sharded_s"], dir_bytes(ck)
    out = os.path.join(d, "ck_q15.gz")
    spy.reset()
    kernels.reset_launches()
    t = time.time()
    require(cli.main(["--load-sharded", ck, "-Q", qfof, "-O", out]) == 0,
            "--load-sharded -Q rc")
    res["a"] = dict(kernels.LAUNCHES)
    wall_q = time.time() - t
    require(gz_bytes(out) == gz_bytes(os.path.join(d, f"q{S}.gz")),
            "--load-sharded -Q output differs from phase 5's")
    require(res["a"]["bcount"] > 0 and res["a"]["psort"] > 0
            and spy.sparse_hits > 0,
            f"--load-sharded -Q skipped K1 or the K2 top-k route: {res['a']}")
    log(f"phase 12 (a): -I -S {S} --save-sharded --shards 4 (v2, gzip) wall "
        f"{wall_save:.2f} s, save_sharded {save_s:.2f} s, {size} bytes on "
        f"disk; --load-sharded -Q wall {wall_q:.2f} s, load_sharded "
        f"{spy.times['load_sharded_s']:.2f} s (times {spy.times}); "
        f"launches {res['a']}; output == phase 5's")
    shutil.rmtree(ck)
    # (b)
    ck = os.path.join(d, "ck_api")
    t = time.time()
    idx15.save_sharded(ck, num_shards=3, compress=False, planes=True)
    save_s = time.time() - t
    size = dir_bytes(ck)
    t = time.time()
    loaded = SketchIndex.load_sharded(ck)
    load_s = time.time() - t
    require(loaded.names == idx15.names
            and np.array_equal(loaded.matrix(), idx15.matrix()),
            "the reloaded phase-4 index differs from the saved one")
    nplanes = planes_files_match(ck, idx15._planes(), idx15.params.W)
    out = os.path.join(d, "ck_m15.gz")
    kernels.reset_launches()
    t = time.time()
    with GzTextWriter(out) as w:
        engine.query_matrix(loaded, w)
    res["b"] = dict(kernels.LAUNCHES)
    wall_m = time.time() - t
    require(gz_bytes(out) == gz_bytes(os.path.join(d, f"m{S}.gz")),
            "the reloaded index's matrix differs from phase 4's output")
    require(res["b"]["bcount"] > 0, f"reloaded -M skipped K2: {res['b']}")
    log(f"phase 12 (b): save_sharded v3 (3 raw shards + planes) {save_s:.2f} "
        f"s, {size} bytes on disk ({nplanes} of planes == the card's "
        f"planes); load_sharded {load_s:.2f} s; query_matrix of the "
        f"reloaded index {wall_m:.2f} s, launches {res['b']}; output == "
        f"phase 4's")
    del loaded
    res["ck_v3"] = ck          # phase 16 restarts from it, then removes it
    # (c)
    ck = os.path.join(d, "ck_s10")
    t = time.time()
    idx10.save_sharded(ck, num_shards=2)
    save_s = time.time() - t
    size = dir_bytes(ck)
    out = os.path.join(d, "ck_q10.gz")
    spy.reset()
    kernels.reset_launches()
    t = time.time()
    require(cli.main(["--load-sharded", ck, "-Q", qfof, "-O", out]) == 0,
            "--load-sharded -Q (S=10) rc")
    res["c"] = dict(kernels.LAUNCHES)
    wall_q = time.time() - t
    require(gz_bytes(out) == gz_bytes(os.path.join(d, "q10.gz")),
            "--load-sharded -Q at S=10 differs from phase 7's output")
    require(res["c"]["pcount"] == 1 and res["c"]["bcount"] == 0,
            f"--load-sharded -Q at S=10 did not count through one K3 "
            f"launch: {res['c']}")
    log(f"phase 12 (c): S=10 save_sharded v2 (2 gzip shards) {save_s:.2f} s, "
        f"{size} bytes on disk; --load-sharded -Q wall {wall_q:.2f} s, "
        f"load_sharded {spy.times['load_sharded_s']:.2f} s; launches "
        f"{res['c']}; output == phase 7's")
    shutil.rmtree(ck)
    return res


def phase_checkpoints_config5(d: str, idx5, planes_s: float) -> dict:
    """Phase 13: phase 10's config-5 index (its full sweep's, whose planes
    are on the card) saved with 8 shards as v3 (raw rows and planes) and as
    v2 (gzip rows), each loaded back: matrix and names equal, the planes
    files equal to the card's planes [:, :G5], and the counts of 96 of its
    own rows through K2 equal on the reloaded index and the original. The
    native pack of the whole matrix is timed beside phase 10's device plane
    build (``planes_s``). Returns the K2 launches of the reloaded counts,
    and the two directories (``dirs``), the 96 rows (``q``) and their
    counts (``want``), kept for phase 17."""
    import gc
    import torch
    from niqki_tpu_torch import SketchIndex, kernels
    from niqki_tpu_torch.ops import bcount
    W = idx5.params.W
    mat = idx5.matrix()
    t = time.time()
    bcount.np_pack_bitplanes(mat, W)
    pack_s = time.time() - t
    rows = sorted(np.random.default_rng(SEED + 13).choice(G5, 96,
                                                          replace=False))
    q = mat[rows]
    want = idx5.counts(q)
    require(int(want.max()) == idx5.params.F, "config-5 rows do not find "
            "themselves")
    dev = idx5._planes()
    res = {"pack_s": pack_s, "planes_s": planes_s, "launches": 0,
           "dirs": {}, "q": q, "want": want}
    for tag, kw in (("v3", {"compress": False, "planes": True}),
                    ("v2", {"compress": True, "planes": False})):
        ck = os.path.join(d, f"ck5_{tag}")
        t = time.time()
        idx5.save_sharded(ck, num_shards=8, **kw)
        save_s = time.time() - t
        size = dir_bytes(ck)
        nplanes = planes_files_match(ck, dev, W) if kw["planes"] else 0
        t = time.time()
        loaded = SketchIndex.load_sharded(ck)
        load_s = time.time() - t
        require(loaded.names == idx5.names and np.array_equal(
            loaded.matrix(), mat), f"the reloaded {tag} config-5 index "
            "differs from the saved one")
        kernels.reset_launches()
        t = time.time()
        got = loaded.counts(q)
        count_s = time.time() - t
        launches = kernels.LAUNCHES["bcount"]
        require(launches > 0 and np.array_equal(got, want),
                f"K2 counts on the reloaded {tag} index differ from the "
                f"original's ({launches} K2 launches)")
        res["launches"] += launches
        res[tag] = {"save_s": save_s, "load_s": load_s, "bytes": size,
                    "planes_bytes": nplanes, "count_s": count_s}
        log(f"phase 13: {tag} save_sharded (8 shards) {save_s:.2f} s, "
            f"{size} bytes on disk ({nplanes} of planes == the card's "
            f"planes); load_sharded {load_s:.2f} s; matrix and names == the "
            f"original's; counts of 96 rows (planes built on the card + K2, "
            f"{launches} launches) {count_s:.2f} s == the original's")
        del loaded, got
        gc.collect()
        torch.cuda.empty_cache()
        res["dirs"][tag] = ck
    log(f"phase 13: native plane pack of the whole matrix ({G5} x "
        f"{idx5.params.F}, W={W}) {pack_s:.3f} s on the host against phase "
        f"10's device plane build {planes_s:.3f} s")
    return res


def trace_kernels(trace_dir: str) -> tuple[str, int, set]:
    """(path, bytes, kernel names) of the one Chrome trace in trace_dir."""
    import glob
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    require(len(files) == 1, f"{len(files)} traces in {trace_dir}")
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]
             if e.get("cat") == "kernel"}
    return files[0], os.path.getsize(files[0]), names


def phase_profile(d: str, fof: str, qfof: str, wall5: float) -> dict:
    """Phase 14: phase 5's -I/-Q at S=15 under --profile: phase 5's bytes,
    and a trace that parses as JSON and names K1's and K2's kernels."""
    import shutil
    from niqki_tpu_torch import cli, kernels
    tr = os.path.join(d, "trace")
    out = os.path.join(d, "prof_q15.gz")
    kernels.reset_launches()
    t = time.time()
    require(cli.main(["-I", fof, "-Q", qfof, "-S", str(S), "-J", "0.05",
                      "--profile", tr, "-O", out]) == 0, "--profile rc")
    wall = time.time() - t
    launches = dict(kernels.LAUNCHES)
    require(gz_bytes(out) == gz_bytes(os.path.join(d, f"q{S}.gz")),
            "the profiled -Q output differs from phase 5's")
    path, size, names = trace_kernels(tr)
    k1 = sorted(n for n in names if "radix_" in n)
    k2 = sorted(n for n in names if "bcount_kernel" in n)
    require(k1 and k2, f"the trace names no K1 or no K2 kernel: {names}")
    log(f"phase 14: -I/-Q -S {S} --profile wall {wall:.2f} s against phase "
        f"5's {wall5:.2f} s; launches {launches}; trace "
        f"{os.path.basename(path)} {size} bytes, {len(names)} kernel names, "
        f"K1 {len(k1)} ({k1[0][:60]}...), K2 {len(k2)}; output == phase 5's")
    shutil.rmtree(tr)
    return {"wall_s": wall, "wall5_s": wall5, "trace_bytes": size,
            "launches": launches}


def phase_mxu() -> dict:
    """Phase 15: NIQKI_TPU_COUNT=mxu (the one-hot matrix product, no
    Pallas kernel in the JAX package and no kernel here) counts NQ queries
    against G rows at S=12, W=12; its counts must equal K2's exactly.
    Both are timed as whole counts calls (median of 3, after one warm
    call)."""
    from niqki_tpu_torch import SketchIndex, SketchParams, kernels
    p = SketchParams(lF=12, min_fract=0.05)
    rng = np.random.default_rng(SEED + 15)
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    share = rng.random((G, p.F)) < 0.5
    mat[share] = np.repeat(mat[::32], 32, axis=0)[share]
    mat[rng.random((G, p.F)) < 0.01] = -1
    idx = SketchIndex.from_arrays(p, [f"x{i}" for i in range(G)], mat)
    q = mat[rng.choice(G, NQ, replace=False)].copy()
    q[rng.random(q.shape) < 0.05] = -1
    res = {}
    for mode in ("bcount", "mxu"):
        os.environ["NIQKI_TPU_COUNT"] = mode
        try:
            kernels.reset_launches()
            res[mode] = {"counts": idx.counts(q)}
            times = []
            for _ in range(3):
                t = time.perf_counter()
                idx.counts(q)
                times.append((time.perf_counter() - t) * 1e3)
            res[mode]["ms"] = statistics.median(times)
            res[mode]["launches"] = dict(kernels.LAUNCHES)
        finally:
            del os.environ["NIQKI_TPU_COUNT"]
    require(np.array_equal(res["mxu"]["counts"], res["bcount"]["counts"]),
            "mxu counts differ from K2's")
    require(res["bcount"]["launches"]["bcount"] > 0
            and res["mxu"]["launches"]["bcount"] == 0,
            f"mxu / K2 routes: {res['mxu']['launches']}, "
            f"{res['bcount']['launches']}")
    require(int(res["mxu"]["counts"].max()) > p.F // 2,
            "mxu check saw no clusters")
    log(f"phase 15: NIQKI_TPU_COUNT=mxu {NQ} x {G} x F={p.F}, W={p.W}: "
        f"{res['mxu']['ms']:.2f} ms a counts call against K2's "
        f"{res['bcount']['ms']:.2f} ms (planes cached), counts equal")
    return {m: {"ms": r["ms"], "launches": r["launches"]}
            for m, r in res.items()}


# ---------------------------------------------------------------------------
# phases 16 and 17: the one-process mesh

TP = 4          # the mesh's tp shards in phases 16 and 17


def check_shards(tp: int = TP, dp: int = 2) -> dict:
    """K2 and K3 at the per-shard shapes of a (dp, tp) mesh over G = 4096
    rows (tp shards of G / tp rows; each device counts its dp slice of the
    queries) and over config 5 (shards of G5 / tp rows at S=12): phase
    16's --mesh 2x4 and phase 17's 1x4 with the defaults, phase 18's 1x8
    with (8, 1). Each shard on the card against the plain version, the
    unsharded call's columns and F - cdist(p=0), timed like phase 2's
    rows, with the unsharded call's device_ms beside it
    (``whole_device_ms``)."""
    import torch
    from niqki_tpu_torch.ops import bcount, pcount
    out = {}
    g, gd, q, xp, qp = bcount_inputs(13)
    B, Gs = bcount.MATRIX_BLOCK, G // tp
    xf = gd.float()
    shapes = (("-M", bcount._planes_as_queries(xp, 0, B).contiguous(),
               g[:B]), ("-Q", qp, q))
    for path, qpl, qsrc in shapes:
        whole = bcount._bcount_call(qpl, xp)
        qf = torch.from_numpy(np.where(qsrc < 0, -3, qsrc)).cuda().float()
        err = 0
        for t in range(tp):
            xs = xp[:, t * Gs:(t + 1) * Gs].contiguous()
            got = bcount._bcount_call(qpl, xs)
            want = bcount._bcount_plain(qpl, xs)
            err = max(err, int((got - want).abs().max()))
            require(torch.equal(got, want)
                    and torch.equal(got, whole[:, t * Gs:(t + 1) * Gs]),
                    f"K2 per shard ({path}, shard {t}) differs from its "
                    "plain version or the unsharded call")
            require(torch.equal(cdist_counts(
                qf, xf[t * Gs:(t + 1) * Gs]).to(torch.int32), got),
                f"F - cdist(p=0) differs from K2 per shard ({path})")
        xs = xp[:, :Gs].contiguous()
        out[f"K2 {path}"] = {
            **bcount_stats(qpl, xs, qf, xf[:Gs], err),
            "whole_device_ms": device_ms(
                lambda: bcount._bcount_call(qpl, xp))}
    del g, gd, xp, qp, xf
    # config 5: a G5 / tp-row shard at S=12, rows 0-767 equal; the sweep's
    # block and the restart's 96 rows as queries
    W, F, Gs5 = 12, 4096, G5 // tp
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    g5 = torch.randint(0, 1 << W, (Gs5, F), dtype=torch.int16,
                       device="cuda", generator=gen)
    g5[:B] = g5[0]
    g5[torch.rand((Gs5, F), device="cuda", generator=gen) < 0.01] = -2
    xs = bcount.pack_bitplanes(g5, W=W, query=False)
    for key, n in (("K2 config-5 block", B), ("K2 config-5 -Q", NQ)):
        qpl = bcount._planes_as_queries(xs, 0, n).contiguous()
        got = bcount._bcount_call(qpl, xs)
        want = bcount._bcount_plain(qpl, xs)
        err = int((got - want).abs().max())
        require(torch.equal(got, want),
                f"{key} per shard differs from its plain version")
        qf = torch.where(g5[:n] < 0, -3, g5[:n]).float()
        require(torch.equal(cdist_counts(qf, g5.float()).to(torch.int32),
                            got),
                f"F - cdist(p=0) differs from {key} per shard")
        out[key] = bcount_stats(qpl, xs, qf, g5.float(), err, plain_reps=3)
        del qpl, qf, got, want
    del g5, xs
    # K3 at S=10: the -M call's dp slice (G / dp of the 4096 queries) and
    # the -Q call's (96 padded to 64 * dp, a dp slice of it) against one
    # shard
    qd, gd, qp, xp = pcount_inputs(G, 10, G)
    step = pcount.PC_BLOCK_Q * dp
    for path, n in (("-M", G // dp), ("-Q", -(-NQ // step) * step // dp)):
        qn = qp[:n].contiguous()
        whole = pcount._count_call(qn, xp)
        for t in range(1, tp):
            got = pcount._count_call(qn, xp[t * Gs:(t + 1) * Gs])
            require(torch.equal(got, whole[:, t * Gs:(t + 1) * Gs]),
                    f"K3 per shard ({path}, shard {t}) differs from the "
                    "unsharded call")
        stats = pcount_stats(qd[:n], gd[:Gs], qn, xp[:Gs], Gs,
                             whole=whole[:, :Gs])
        stats["whole_device_ms"] = device_ms(
            lambda: pcount._count_call(qn, xp))
        out[f"K3 {path}"] = stats
    return out


def phase_mesh(d: str, fof: str, qfof: str, allfa: str, qfa: str, ref5,
               ck_v3: str, spy: "Spy", single: dict) -> dict:
    """Phase 16: the one-process mesh at G = 4096 on eight virtual devices
    of the card (--mesh 2x4): the CLI's -M and -I/-Q at S=15 and S=10 and
    -i/-l must give phases 4-8's bytes through per-shard K2 and K3 and K1
    per device (exact launch counts); ShardedIndex.from_checkpoint of
    phase 12's v3 directory under 1x4 must count phase 5's queries as
    phase 5's reference did; then entry.dryrun_multichip(8) and the kernel
    checks at the per-shard shapes (check_shards). ``single`` holds the
    single-device runs' launches (phase 4's -M, ``m15``)."""
    import shutil
    import torch
    from niqki_tpu_torch import cli, kernels
    from niqki_tpu_torch.entry import dryrun_multichip
    from niqki_tpu_torch.parallel.mesh import device_list, make_mesh
    from niqki_tpu_torch.parallel.serving import ShardedIndex
    res = {}

    def run(tag, args, want):
        out = os.path.join(d, f"mesh_{len(res)}.gz")
        spy.reset()
        kernels.reset_launches()
        t = time.time()
        rc = cli.main(args + ["--mesh", "2x4", "-O", out])
        wall = time.time() - t
        launches = dict(kernels.LAUNCHES)
        require(rc == 0, f"--mesh 2x4 {tag} rc")
        require(gz_bytes(out) == gz_bytes(os.path.join(d, want)),
                f"--mesh 2x4 {tag} output differs from {want}")
        os.remove(out)
        res[tag] = {"wall_s": wall, "launches": launches,
                    "shapes": spied_shapes(spy, launches),
                    "k2": spy.k2_summary(), "sparse": spy.sparse_hits,
                    "sweep": spy.mesh_stats,
                    "times": {k: round(v, 3) for k, v in spy.times.items()}}
        log(f"phase 16: --mesh 2x4 {tag} wall {wall:.2f} s; launches "
            f"{launches}, by shape {res[tag]['shapes']}; K2 "
            f"{res[tag]['k2']['launches']} launches, "
            f"{res[tag]['k2']['device_ms']:.1f} event ms; sparse top-k "
            f"batches {spy.sparse_hits}; mesh sweep {spy.mesh_stats}; "
            f"output == {want}")
        return launches

    os.environ["NIQKI_TPU_VIRTUAL_DEVICES"] = "8"
    try:
        m = run("-M -S 15", ["-M", fof, "-S", str(S), "-J", "0.05"],
                f"m{S}.gz")
        require(m["bcount"] == 24 and m["pcount"] == 0
                and m["psort"] == 8 * single["m15"]["psort"]
                and res["-M -S 15"]["sweep"]["blocks"] == 6,
                f"-M -S 15 on 2x4 launched {m}, not 24 K2 (6 blocks x 4 "
                f"shards) and 8 K1 for each of phase 4's "
                f"{single['m15']['psort']}")
        m = run("-I/-Q -S 15", ["-I", fof, "-Q", qfof, "-S", str(S), "-J",
                                "0.05"], f"q{S}.gz")
        require(m["bcount"] == 8 and m["psort"] % 8 == 0
                and res["-I/-Q -S 15"]["sparse"] > 0,
                f"-I/-Q -S 15 on 2x4 did not take per-shard top-k through "
                f"8 K2 launches: {m}")
        for tag, args, want in (
                ("-M -S 10", ["-M", fof, "-S", "10", "-J", "0.05"],
                 "m10.gz"),
                ("-I/-Q -S 10", ["-I", fof, "-Q", qfof, "-S", "10", "-J",
                                 "0.05"], "q10.gz")):
            m = run(tag, args, want)
            require(m["pcount"] == 8 and m["bcount"] == 0,
                    f"{tag} on 2x4 did not count through 8 K3 launches "
                    f"(one a device): {m}")
        m = run("-i/-l", ["-i", allfa, "-l", qfa, "-J", "0.05"], "lines.gz")
        require(m["psort"] > 0 and m["psort"] % 8 == 0 and m["bcount"] > 0
                and res["-i/-l"]["sparse"] > 0,
                f"-i/-l on 2x4 skipped K1 per device or per-shard top-k: "
                f"{m}")
        # the mesh-direct restart of phase 12's v3 directory under 1x4
        mesh = make_mesh(device_list("cuda")[:TP], dp=1, tp=TP)
        t = time.time()
        srv = ShardedIndex.from_checkpoint(ck_v3, mesh)
        torch.cuda.synchronize()
        load_s = time.time() - t
        spy.reset()
        kernels.reset_launches()
        t = time.time()
        got = srv.counts(ref5["q"])
        count_s = time.time() - t
        launches = dict(kernels.LAUNCHES)
        require(np.array_equal(got, ref5["counts"]),
                "from_checkpoint counts on 1x4 differ from phase 5's")
        require(launches["bcount"] == TP, f"from_checkpoint counts on 1x4 "
                f"did not launch K2 once a shard: {launches}")
        res["restart"] = {"load_s": load_s, "count_s": count_s,
                          "launches": launches,
                          "shapes": spied_shapes(spy, launches)}
        log(f"phase 16: ShardedIndex.from_checkpoint (v3, 3 raw shards, "
            f"S=15) on 1x4 {load_s:.2f} s, counts of {NQ} queries "
            f"{count_s:.2f} s == phase 5's reference; launches {launches}")
        del srv
        t = time.time()
        spy.reset()
        kernels.reset_launches()
        dryrun_multichip(8)
        res["dryrun"] = {"s": time.time() - t,
                         "launches": dict(kernels.LAUNCHES)}
        res["dryrun"]["shapes"] = spied_shapes(spy, res["dryrun"]["launches"])
        spy.reset()
        log(f"phase 16: entry.dryrun_multichip(8) OK in "
            f"{res['dryrun']['s']:.2f} s; launches "
            f"{res['dryrun']['launches']}")
    finally:
        del os.environ["NIQKI_TPU_VIRTUAL_DEVICES"]
        shutil.rmtree(ck_v3)
    torch.cuda.empty_cache()
    res["shards"] = check_shards()
    for key, e in res["shards"].items():
        log(f"phase 16: {key} per shard {e}")
    return res


def phase_mesh_config5(d: str, fa: str, sha_full: str, p13: dict,
                       spy: "Spy") -> dict:
    """Phase 17: BASELINE config 5 under --mesh 1x4 (four virtual devices
    of the card): phase 10's -i/-M through the mesh's full sweep must give
    phase 10's SHA-256 through exactly 134 x 4 = 536 K2 launches; then
    ShardedIndex.from_checkpoint of phase 13's v3 and v2 directories
    under 1x4 must count phase 13's 96 rows as phase 13 did."""
    os.environ["NIQKI_TPU_VIRTUAL_DEVICES"] = str(TP)
    try:
        res = phase17_sweep(d, fa, sha_full, spy)
        res.update(phase17_restarts(p13, spy))
    finally:
        del os.environ["NIQKI_TPU_VIRTUAL_DEVICES"]
        os.remove(fa)
    return res


def phase17_sweep(d: str, fa: str, sha_full: str, spy: "Spy") -> dict:
    """Phase 17's -i/-M run (phase_mesh_config5)."""
    import gc
    import torch
    from niqki_tpu_torch import cli, kernels
    out = os.path.join(d, "config5_mesh.gz")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spy.reset()
    kernels.reset_launches()
    t = time.time()
    try:
        rc = cli.main(["-i", fa, "-M", fa, "-S", "12", "-J", "0.05",
                       "--mesh", f"1x{TP}", "-O", out])
        launches = dict(kernels.LAUNCHES)
        wall = time.time() - t
        require(rc == 0, "config 5 --mesh 1x4 rc")
        res = {"wall_s": wall, "launches": launches,
               "shapes": spied_shapes(spy, launches),
               "k2": spy.k2_summary(), "sweep": spy.mesh_stats,
               "times": {k: round(v, 3) for k, v in spy.times.items()},
               "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
               "sha256": sha256(out)}
    finally:
        spy.reset()
        if os.path.exists(out):
            os.remove(out)
    require(res["sha256"] == sha_full, "config 5 on 1x4 differs from phase "
            f"10's output: sha256 {res['sha256']} vs {sha_full}")
    st = res["sweep"]
    require(st is not None and st["blocks"] == 134 and st["tp"] == TP
            and st["refetch"] == 0 and launches["bcount"] == 536,
            f"config 5 on 1x4: {launches}, sweep {st}; expected 536 K2 "
            "launches (134 blocks x 4 shards)")
    log(f"phase 17: config 5 -i/-M --mesh 1x{TP} wall {wall:.2f} s; "
        f"{res['times']} (ingest_s: -i; sweep_s: the ShardedIndex build and "
        f"the sweep); mesh sweep {st}; launches {launches}; K2 "
        f"{res['k2']['launches']} launches, {res['k2']['device_ms']:.1f} "
        f"event ms; peak device memory {res['peak_device_gib']:.3f} GiB; "
        f"sha256 == phase 10's")
    return res


def phase17_restarts(p13: dict, spy: "Spy") -> dict:
    """Phase 17's mesh-direct restarts (phase_mesh_config5);
    ``restart_shapes`` holds both restarts' launches by shape."""
    import gc
    import shutil
    import torch
    from niqki_tpu_torch import kernels
    from niqki_tpu_torch.parallel.mesh import device_list, make_mesh
    from niqki_tpu_torch.parallel.serving import ShardedIndex
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(device_list("cuda")[:TP], dp=1, tp=TP)
    res = {"restart_shapes": {}}
    for tag in ("v3", "v2"):
        ck = p13["dirs"][tag]
        t = time.time()
        srv = ShardedIndex.from_checkpoint(ck, mesh)
        torch.cuda.synchronize()
        load_s = time.time() - t
        spy.reset()
        kernels.reset_launches()
        t = time.time()
        got = srv.counts(p13["q"])
        count_s = time.time() - t
        k2 = kernels.LAUNCHES["bcount"]
        add_shapes(res["restart_shapes"], spied_shapes(spy, kernels.LAUNCHES))
        require(np.array_equal(got, p13["want"]) and k2 == TP,
                f"from_checkpoint ({tag}) counts on 1x4 differ from phase "
                f"13's ({k2} K2 launches)")
        res[tag] = {"load_s": load_s, "count_s": count_s, "launches": k2}
        log(f"phase 17: ShardedIndex.from_checkpoint ({tag}, 8 shards) on "
            f"1x{TP} {load_s:.2f} s, counts of 96 rows {count_s:.2f} s "
            f"== phase 13's; {k2} K2 launches")
        del srv, got
        gc.collect()
        torch.cuda.empty_cache()
        if tag == "v2":         # phases 18 and 19 read v3; 19 removes it
            shutil.rmtree(ck)
    return res


# ---------------------------------------------------------------------------
# phase 18: the multi-process mesh, two gloo ranks on the one card

RANKS, RANK_DEVICES = 2, 4      # phase 18: two ranks of 4 virtual devices
RANK_TIMEOUT = 600              # seconds both ranks may take together


def gloo_cuda_probe(rank: int) -> dict:
    """Whether gloo takes CUDA tensors itself (the port's collectives stage
    every gloo payload through the host and do not rely on it): an
    all-reduce MIN and an all-gather of int32 tensors on cuda:0, the
    result or the first line of the error. Both ranks make the same calls,
    so both see the same outcome."""
    import torch
    import torch.distributed as dist
    out = {}
    x = torch.full((4,), rank + 1, dtype=torch.int32, device="cuda")
    try:
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        out["all_reduce_min"] = "ok" if bool((x == 1).all()) else "wrong"
    except RuntimeError as e:
        out["all_reduce_min"] = str(e).splitlines()[0][:200]
    y = torch.full((4,), rank, dtype=torch.int32, device="cuda")
    outs = [torch.empty_like(y) for _ in range(RANKS)]
    try:
        dist.all_gather(outs, y)
        out["all_gather"] = "ok" if all(
            bool((o == r).all()) for r, o in enumerate(outs)) else "wrong"
    except RuntimeError as e:
        out["all_gather"] = str(e).splitlines()[0][:200]
    return out


def hold_shards(srv, rows=None, n_q: int = NQ) -> dict:
    """Every shard this rank holds of ``srv`` (a ShardedIndex) through its
    kernel and its plain version at the shapes the rank launched, exactly:
    K2 at a MATRIX_BLOCK of the shard's stored rows as queries (the
    sweep's block) and at ``n_q`` of them (a -Q block); K3 at ``rows``
    (int16 queries: a dp slice of the index, the -M call's) and at the
    first ``n_q`` of them (a -Q call's dp slice). Returns the calls held
    by shape and the largest error."""
    import torch
    from niqki_tpu_torch.ops import bcount, pcount
    held, err = {}, 0
    shards = srv._planes if srv._kernel == "planes" else srv._mat
    seen = set()
    for xs in (x for row in shards.parts for x in row if x is not None):
        if xs.data_ptr() in seen:
            continue
        seen.add(xs.data_ptr())
        if srv._kernel == "planes":
            B, Gs = bcount.MATRIX_BLOCK, xs.shape[1]
            rows = xs.repeat(1, -(-B // Gs), 1)[:, :B]
            P = rows.shape[0]
            qp = torch.cat([rows[:P - 1] | rows[P - 1:], rows[P - 1:]])
            calls = [(qp[:, :n].contiguous(), bcount._bcount_call,
                      bcount._bcount_plain) for n in (B, n_q)]
        else:
            q = pcount.pack_rows(torch.from_numpy(rows).to(xs.device))
            calls = [(q[:n].contiguous(), pcount._count_call,
                      pcount._count_plain) for n in (len(rows), n_q)]
        for qx, kernel, plain in calls:
            got, want = kernel(qx, xs), plain(qx, xs)
            err = max(err, int((got - want).abs().max()))
            require(torch.equal(got, want), f"{kernel.__name__} per shard "
                    f"at {tuple(qx.shape)} x {tuple(xs.shape)} differs from "
                    "its plain version")
            shape = f"{tuple(qx.shape)} x {tuple(xs.shape)}"
            held[shape] = held.get(shape, 0) + 1
    return {"held": held, "max_abs_err": err}


def phase18_rank(rank: int, port: int, d: str) -> int:
    """One of phase 18's ranks (``chip_smoke.py --phase18-rank R PORT
    DIR``): init_distributed over gloo, four virtual devices of cuda:0,
    then the API on one global mesh of 8. Each path runs with the launch
    counts, the Spy and the collective stats set to 0 just before it and
    read just after; its outputs go to DIR for the parent to check; the
    rank's numbers go to DIR/phase18_rank{R}.json."""
    os.environ["NIQKI_TPU_VIRTUAL_DEVICES"] = str(RANK_DEVICES)
    import torch
    from niqki_tpu_torch import SketchIndex, SketchParams, engine, kernels
    from niqki_tpu_torch.io.writers import GzTextWriter
    from niqki_tpu_torch.ops import pcount, psort
    from niqki_tpu_torch.parallel import collective
    from niqki_tpu_torch.parallel.auto import active_mesh
    from niqki_tpu_torch.parallel.serving import init_distributed
    with open(os.path.join(d, "phase18.json")) as f:
        cfg = json.load(f)
    init_distributed(f"127.0.0.1:{port}", RANKS, rank, backend="gloo")
    res = {"rank": rank, "probe": gloo_cuda_probe(rank), "paths": {},
           "held": {}}
    spy = Spy()

    def run(tag, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spy.reset()
        kernels.reset_launches()
        collective.reset_stats()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = dict(kernels.LAUNCHES)
        res["paths"][tag] = {
            "wall_s": wall, "launches": launches,
            "shapes": {f"{k}|{shp}": n for (k, shp), n in
                       spied_shapes(spy, launches).items()},
            "collectives": dict(collective.STATS),
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "sweep": spy.mesh_stats}
        log(f"phase 18 rank {rank}: {tag} {res['paths'][tag]}")
        return out

    def write(tag, fn):
        path = os.path.join(d, f"r{rank}_{tag}.gz")
        with GzTextWriter(path) as out:
            fn(out)

    try:
        for S_, lay0 in ((15, "2x4"), (10, "1x8")):
            os.environ["NIQKI_TPU_MESH"] = lay0
            idx = SketchIndex(SketchParams(lF=S_, min_fract=0.05))
            run(f"ingest S={S_} {lay0}",
                lambda: engine.insert_fof_whole(idx, cfg["fof"]))
            for lay in ("1x8", "2x4"):
                os.environ["NIQKI_TPU_MESH"] = lay
                run(f"-M S={S_} {lay}", lambda: write(
                    f"m{S_}_{lay}", lambda out: engine.query_matrix(idx,
                                                                    out)))
                run(f"-Q S={S_} {lay}", lambda: write(
                    f"q{S_}_{lay}", lambda out: engine.query_fof_whole(
                        idx, cfg["qfof"], out)))
                srv = idx._sharded
                step = pcount.PC_BLOCK_Q * srv._dp      # -Q's K3 padding
                res["held"][f"S={S_} {lay}"] = hold_shards(
                    srv, idx._stored()[:G // srv._dp].astype(np.int16),
                    n_q=NQ if S_ == 15 else -(-NQ // step) * step // srv._dp)
            del idx, srv
        # config 5: the mesh-direct restart under 1x8, then -M
        os.environ["NIQKI_TPU_MESH"] = "1x8"
        mesh = active_mesh("cuda")
        q5 = np.load(os.path.join(d, "phase18_q5.npz"))
        idx5 = run("restart config 5 1x8", lambda: SketchIndex.load_sharded(
            cfg["ck5"], mesh=mesh))
        got = run("counts config 5 1x8", lambda: idx5.counts(q5["q"]))
        require(np.array_equal(got, q5["want"]), f"rank {rank}: config-5 "
                "counts after the 1x8 restart differ from phase 13's")
        run("-M config 5 1x8", lambda: write(
            "m5", lambda out: engine.query_matrix(idx5, out)))
        res["held"]["config 5 1x8"] = hold_shards(idx5._sharded)
        # K1 at a device's share of the ingest's 256-record batches
        keys = record_keys(256 // (RANKS * RANK_DEVICES), LEN, 1 << 17,
                           seed=rank)
        require(torch.equal(psort.sort_i32_pow2_batch(keys),
                            psort.sort_plain(keys)),
                f"rank {rank}: K1 differs from torch.sort")
        res["held"]["K1"] = {"held": {f"{tuple(keys.shape)}": 1},
                             "max_abs_err": 0}
        torch.distributed.barrier()
    finally:
        os.environ.pop("NIQKI_TPU_MESH", None)
        spy.close()
    with open(os.path.join(d, f"phase18_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_multiprocess(d: str, fof: str, qfof: str, p13: dict, sha5: str,
                       single: dict) -> dict:
    """Phase 18: two ranks (phase18_rank) over gloo, both on cuda:0 with
    four virtual devices each, one global mesh of 8: (a) at G = 4096 the
    -M and -I/-Q of phases 4-7 under 1x8 and 2x4 (an ingest at S=15 under
    2x4 and at S=10 under 1x8), each rank's bytes equal to phases 4-7's;
    (b) config 5 restarted from phase 13's v3 directory under 1x8: phase
    13's counts of 96 rows, then -M with phase 10's SHA-256, on each rank.
    Every rank's launches per path are checked exactly where the layout
    fixes them. A rank that fails or outlasts RANK_TIMEOUT fails the
    phase; both are stopped. ``single``: phase 4's launches (``m15``) and
    the one-process twins' walls (``walls``)."""
    import shutil
    import socket
    np.savez(os.path.join(d, "phase18_q5.npz"), q=p13["q"], want=p13["want"])
    with open(os.path.join(d, "phase18.json"), "w") as f:
        json.dump({"fof": fof, "qfof": qfof, "ck5": p13["dirs"]["v3"]}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [os.path.join(d, f"phase18_rank{r}.log") for r in range(RANKS)]
    t = time.time()
    procs = []
    for r in range(RANKS):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase18-rank",
                 str(r), str(port), d], stdout=f, stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() - t > RANK_TIMEOUT:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.time() - t
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path, errors="replace") as f:
            tail = f.read()[-3000:]
        require(p.returncode == 0, f"phase 18 rank {r} exited "
                f"{p.returncode} after {wall:.1f} s:\n{tail}")
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(d, f"phase18_rank{r}.json")) as f:
            ranks.append(json.load(f))
    # each rank's bytes
    for S_ in (15, 10):
        for lay in ("1x8", "2x4"):
            for kind in ("m", "q"):
                want = gz_bytes(os.path.join(d, f"{kind}{S_}.gz"))
                for r in range(RANKS):
                    path = os.path.join(d, f"r{r}_{kind}{S_}_{lay}.gz")
                    require(gz_bytes(path) == want, f"phase 18 rank {r}: "
                            f"{kind}{S_} under {lay} differs from "
                            f"{kind}{S_}.gz")
                    os.remove(path)
    for r in range(RANKS):
        path = os.path.join(d, f"r{r}_m5.gz")
        got = sha256(path)
        os.remove(path)
        require(got == sha5, f"phase 18 rank {r}: config 5 -M after the 1x8 "
                f"restart has sha256 {got}, phase 10's {sha5}")
    # launches per rank and path, where the layout fixes them
    k1_single = single["m15"]["psort"]

    def n(r, tag, k):
        return ranks[r]["paths"][tag]["launches"][k]
    for r in range(RANKS):
        row0 = r == 0        # 2x4: dp row 0 (the sweep's) is rank 0's
        want = {("ingest S=15 2x4", "psort"): RANK_DEVICES * k1_single,
                ("-M S=15 1x8", "bcount"): 24,
                ("-M S=15 2x4", "bcount"): 24 if row0 else 0,
                ("-Q S=15 1x8", "bcount"): RANK_DEVICES,
                ("-Q S=15 2x4", "bcount"): RANK_DEVICES,
                ("-M S=10 1x8", "pcount"): RANK_DEVICES,
                ("-M S=10 2x4", "pcount"): RANK_DEVICES,
                ("-Q S=10 1x8", "pcount"): RANK_DEVICES,
                ("-Q S=10 2x4", "pcount"): RANK_DEVICES,
                ("counts config 5 1x8", "bcount"): RANK_DEVICES,
                ("-M config 5 1x8", "bcount"): 134 * RANK_DEVICES}
        for (tag, k), v in want.items():
            require(n(r, tag, k) == v, f"phase 18 rank {r}: {tag} launched "
                    f"{k} {n(r, tag, k)} times, not {v}")
        for tag in ("ingest S=10 1x8", "-Q S=15 1x8", "-Q S=15 2x4",
                    "-Q S=10 1x8", "-Q S=10 2x4"):
            require(n(r, tag, "psort") > 0,
                    f"phase 18 rank {r}: {tag} launched no K1")
        st = ranks[r]["paths"]["-M config 5 1x8"]["sweep"]
        require(st["blocks"] == 134 and st["refetch"] == 0,
                f"phase 18 rank {r}: config-5 sweep {st}")
    for r in range(RANKS):
        for tag, e in ranks[r]["paths"].items():
            log(f"phase 18 rank {r}: {tag}: wall {e['wall_s']:.2f} s, "
                f"launches {e['launches']}, collectives "
                f"{e['collectives']['calls']} calls "
                f"{e['collectives']['bytes'] / 2**20:.1f} MiB sent "
                f"{e['collectives']['seconds']:.2f} s, peak device "
                f"{e['peak_device_gib']:.3f} GiB")
        log(f"phase 18 rank {r}: kernels held per shard {ranks[r]['held']}; "
            f"gloo with CUDA tensors: {ranks[r]['probe']}")
    log(f"phase 18: two gloo ranks on cuda:0 in {wall:.1f} s; every rank's "
        f"bytes == phases 4-7's under 1x8 and 2x4, config 5's counts == "
        f"phase 13's and -M sha256 == phase 10's; one-process twins' walls: "
        f"{single['walls']}")
    return {"wall_s": wall, "ranks": ranks}


# ---------------------------------------------------------------------------
# phase 19: the rest of the surface

ECOLI, N_ECOLI = 4_640_000, 6    # phase 19 (a): E. coli-sized records


def ecoli_records():
    """N_ECOLI random records of ECOLI bases as (eff_fwd, eff_rc) codes
    (numpy seed SEED + 19); the last holds 40 runs of 1000 N, where both
    codes are 0, as the encoders give them."""
    rng = np.random.default_rng(SEED + 19)
    out = []
    for i in range(N_ECOLI):
        f = rng.integers(0, 4, ECOLI, dtype=np.uint8)
        r = (3 - f).astype(np.uint8)
        if i == N_ECOLI - 1:
            for at in rng.integers(0, ECOLI - 1000, 40):
                f[at:at + 1000] = 0
                r[at:at + 1000] = 0
        out.append((f, r))
    return out


def wall_ms(fn, reps: int = 5) -> float:
    """Median milliseconds from calling fn() to the card finishing its
    work (host share included)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def spied_run(spy: "Spy", fn):
    """fn() with every launch count set to 0 just before and read just
    after: (result, launches, launches by (kernel, shape))."""
    from niqki_tpu_torch import kernels
    spy.reset()
    kernels.reset_launches()
    out = fn()
    launches = dict(kernels.LAUNCHES)
    return out, launches, spied_shapes(spy, launches)


def phase19_sketch(spy: "Spy") -> dict:
    """Phase 19 (a): sketch_codes of six E. coli-sized records on the
    card, K1 at 1 x 2^23 once each, every table equal to the host's
    rolling sketch (native.sketch_codes_cpu) and to the same keys sorted by
    torch.sort, K1's plain version; 20 kb records at lF = 24
    and W = 30 take the scatter-min and equal the host's sketch;
    dispatch_sketch of one record and K1's share of it are timed."""
    import torch
    from niqki_tpu_torch import SketchParams, native
    from niqki_tpu_torch.ops import psort, sketch
    p = SketchParams(lF=S)
    recs = ecoli_records()
    tables, launches, shapes = spied_run(spy, lambda: [
        sketch.sketch_codes(f, r, p) for f, r in recs])
    key = (1 << 23)
    require(launches["psort"] == N_ECOLI and shapes.get(
        ("psort", f"1x{key}"), 0) == N_ECOLI,
        f"sketch_codes of {N_ECOLI} records: K1 launches {shapes}")
    t = time.time()
    for (f, r), tab in zip(recs, tables):
        require(np.array_equal(tab, native.sketch_codes_cpu(
            f, r, p.lF, p.K, p.W, p.H)), "a sketch_codes table differs "
            "from native.sketch_codes_cpu")
    host_s = time.time() - t
    require(all((tab == sketch.INT32_MAX).sum() < p.F for tab in tables),
            "sketch tables are empty")
    Wb = sketch._fp_bits(p.W, p.H, p.mask_M, p.maximal_remainder)

    def ecoli_keys(f, r):
        """The record's composite keys, padded to K1's 2^23 row."""
        codes = torch.from_numpy(np.stack([f, r])).cuda()
        nk = torch.full((1,), len(f) - p.K, dtype=torch.int32,
                        device="cuda")
        keys = sketch._keys_core(codes[0:1], codes[1:2], nk, lF=p.lF,
                                 K=p.K, W=p.W, H=p.H)
        return torch.nn.functional.pad(keys, (0, key - keys.shape[1]),
                                       value=sketch.INT32_MAX).contiguous()
    for (f, r), tab in zip(recs, tables):
        plain = sketch._extract_core(psort.sort_plain(ecoli_keys(f, r)),
                                     lF=p.lF, Wb=Wb)
        require(np.array_equal(plain[0].cpu().numpy(), tab),
                "a sketch_codes table differs from the same keys sorted "
                "by torch.sort")
    rng = np.random.default_rng(SEED + 20)
    scatter = {}
    for tag, kw in (("lF=24", dict(lF=24)), ("W=30", dict(lF=12, W=30))):
        q = SketchParams(**kw)
        f = rng.integers(0, 4, 20_000, dtype=np.uint8)
        r = (3 - f).astype(np.uint8)
        (tab,), sl, _ = spied_run(spy, lambda: [sketch.sketch_codes(f, r, q)])
        require(sl["psort"] == 0 and np.array_equal(
            tab, native.sketch_codes_cpu(f, r, q.lF, q.K, q.W, q.H)),
            f"scatter-min sketch at {tag} differs from the host's ({sl})")
        scatter[tag] = int((tab != sketch.INT32_MAX).sum())
    f, r = recs[0]
    disp_ms = wall_ms(lambda: sketch.dispatch_sketch(f, r, p))
    keys = ecoli_keys(f, r)
    k1_ms = time_cuda(lambda: psort.sort_i32_pow2_batch(keys), reps=5)
    del keys
    res = {"launches": launches, "shapes": shapes, "dispatch_ms": disp_ms,
           "k1_ms": k1_ms, "k1_share": k1_ms / disp_ms,
           "host_check_s": host_s, "scatter_slots": scatter}
    log(f"phase 19 (a): sketch_codes of {N_ECOLI} x {ECOLI} bases: "
        f"{N_ECOLI} K1 launches at 1 x 2^23, tables == "
        f"native.sketch_codes_cpu ({host_s:.2f} s) and == torch.sort of "
        f"the same keys; scatter-min at lF=24 / W=30 == host ({scatter} "
        f"slots filled); dispatch_sketch {disp_ms:.3f} ms a record, K1 "
        f"{k1_ms:.3f} ms of it ({100 * k1_ms / disp_ms:.1f}%)")
    return res


def phase19_all_vs_all(spy: "Spy", idx, kernel: str, want: dict) -> dict:
    """Phase 19 (b): idx.all_vs_all_counts() through ``kernel`` with the
    launches ``want`` by shape; 96 sampled rows equal native.count_eq and
    the diagonal is F."""
    from niqki_tpu_torch import native
    p = idx.params
    t = time.time()
    c, launches, shapes = spied_run(spy, idx.all_vs_all_counts)
    wall = time.time() - t
    got = {k: n for (kk, k), n in shapes.items() if kk == kernel}
    require(got == want and sum(launches.values()) == sum(want.values()),
            f"all_vs_all_counts at S={p.lF}: launches {shapes}, want "
            f"{kernel} {want}")
    require(c.shape == (idx.G, idx.G) and (np.diag(c) == p.F).all(),
            f"all_vs_all_counts at S={p.lF}: shape {c.shape} or diagonal")
    rows = sorted(np.random.default_rng(SEED + 21).choice(idx.G, 96,
                                                          replace=False))
    ref = native.count_eq(idx.matrix()[rows], idx._stored(),
                          p.fingerprint_range)
    require(np.array_equal(c[rows], ref), f"all_vs_all_counts at S={p.lF}: "
            "sampled rows differ from native.count_eq")
    log(f"phase 19 (b): all_vs_all_counts at S={p.lF} ({idx.G}^2) "
        f"{wall:.2f} s, {kernel} launches {got}; 96 rows == "
        f"native.count_eq, diagonal == F")
    return {"wall_s": wall, "launches": launches, "shapes": shapes}


def phase19_config5(spy: "Spy", p13: dict) -> dict:
    """Phase 19 (c) and (d): phase 13's v3 directory loaded; hits of 8 of
    phase 13's rows == hits_from_counts of phase 13's counts;
    ShardedIndex.from_checkpoint(ck).hits == SketchIndex.load_sharded(ck)
    .hits for a random query; the 96 counts through the reloaded index ==
    phase 13's; K2 at 96 x 102,400 x 128 lanes held against its plain
    version and timed. Returns the loaded index's names too, for the
    writer's row text."""
    import torch
    from niqki_tpu_torch import SketchIndex
    from niqki_tpu_torch.ops import bcount
    from niqki_tpu_torch.parallel.serving import ShardedIndex
    ck, q, want = p13["dirs"]["v3"], p13["q"], p13["want"]
    t = time.time()
    idx = SketchIndex.load_sharded(ck)
    load_s = time.time() - t
    picks = list(range(0, 96, 12))
    t = time.time()
    hits, hl, hshapes = spied_run(spy, lambda: [idx.hits(q[i])
                                                for i in picks])
    hits_s = time.time() - t
    for i, h in zip(picks, hits):
        require(h == idx.hits_from_counts(want[i]) and len(h) > 1,
                f"hits of row {i} differ from phase 13's counts")
    require(hl["bcount"] == len(picks), f"hits: K2 launches {hshapes}")
    rng = np.random.default_rng(SEED + 22)
    rq = idx.matrix()[int(rng.integers(idx.G))].copy()
    flip = rng.random(rq.shape) < 0.3
    rq[flip] = rng.integers(0, 1 << idx.params.W, int(flip.sum()))
    t = time.time()
    srv = ShardedIndex.from_checkpoint(ck)
    (srv_hits, one_hits), _, rshapes = spied_run(
        spy, lambda: (srv.hits(rq), idx.hits(rq)))
    srv_s = time.time() - t
    require(srv_hits == one_hits and len(srv_hits) > 1,
            "ShardedIndex.from_checkpoint(ck).hits differs from "
            "SketchIndex.load_sharded(ck).hits")
    add_shapes(hshapes, rshapes)
    del srv
    t = time.time()
    got, sl, sshapes = spied_run(spy, lambda: idx.counts(q))
    counts_s = time.time() - t
    require(np.array_equal(got, want) and sl["bcount"] == 1,
            f"counts of the reloaded index differ from phase 13's ({sl})")
    # K2 at the shape of these counts, against its plain version
    W = idx.params.W
    xp = idx._planes()
    q16 = idx._query_side(q).astype(np.int16)
    qd = torch.from_numpy(q16).cuda()
    qp = bcount.pack_bitplanes(qd, W=W, query=True)
    k2 = bcount._bcount_call(qp, xp)
    plain = bcount._bcount_plain(qp, xp)
    err = int((k2 - plain).abs().max())
    xf = torch.from_numpy(idx._stored()).cuda().float()
    qf = qd.float()
    require(err == 0 and np.array_equal(k2.cpu().numpy()[:, :idx.G], want)
            and torch.equal(cdist_counts(qf, xf).to(torch.int32), k2),
            "K2 at 96 x 102,400 x 128 lanes differs from its plain version, "
            "phase 13's counts or F - cdist")
    k2_rows = bcount_stats(qp, xp, qf, xf, err, plain_reps=3)
    qp1 = qp[:, :1].contiguous()          # the shape of one hits() query
    err1 = int((bcount._bcount_call(qp1, xp) - plain[:1]).abs().max())
    require(err1 == 0, "K2 at 1 x 102,400 x 128 lanes differs from its "
            "plain version")
    k2_hit = bcount_stats(qp1, xp, qf[:1], xf, err1, plain_reps=3)
    del k2, plain, xf, qf, qp1
    names, params = idx.names, idx.params
    del idx, xp, qd, qp
    torch.cuda.empty_cache()
    log(f"phase 19 (c): load_sharded v3 {load_s:.2f} s; hits of {len(picks)} "
        f"rows {hits_s:.2f} s == hits_from_counts of phase 13's counts "
        f"(K2 {hshapes}); ShardedIndex.from_checkpoint(ck).hits == "
        f"load_sharded(ck).hits for a random query ({len(srv_hits)} hits, "
        f"{srv_s:.2f} s)")
    log(f"phase 19 (d): 96 counts of the reloaded index {counts_s:.2f} s "
        f"== phase 13's (K2 {sshapes}); K2 at 96 x 102,400 x 128 lanes "
        f"{k2_rows}, at 1 x 102,400 (hits) {k2_hit}")
    return {"load_s": load_s, "hits_s": hits_s, "counts_s": counts_s,
            "hits_shapes": hshapes, "counts_shapes": sshapes,
            "k2_rows": k2_rows, "k2_hit": k2_hit,
            "names": names, "params": params,
            "launches": add_shapes(dict(hshapes), sshapes)}


def phase19_outputs(d: str, spy: "Spy", idx10) -> dict:
    """Phase 19 (e)'s output: phase 6's -M -S 10 under NIQKI_TPU_GZLEVEL=1
    (phase 6's decompressed bytes)."""
    from niqki_tpu_torch import engine
    from niqki_tpu_torch.io.writers import GzTextWriter
    out, want = os.path.join(d, "p19.gz"), os.path.join(d, "m10.gz")

    def write():
        with GzTextWriter(out) as w:
            engine.query_matrix(idx10, w)
    os.environ["NIQKI_TPU_GZLEVEL"] = "1"
    try:
        t = time.time()
        _, launches, shapes = spied_run(spy, write)
        wall = time.time() - t
    finally:
        del os.environ["NIQKI_TPU_GZLEVEL"]
    require(gz_bytes(out) == gz_bytes(want),
            "phase 19: -M -S 10 at gzip level 1 differs from m10.gz's bytes")
    res = {"wall_s": wall, "launches": launches, "shapes": shapes,
           "bytes": os.path.getsize(out), "want_bytes": os.path.getsize(want)}
    os.remove(out)
    log(f"phase 19: -M -S 10 level 1 {wall:.2f} s == m10.gz decompressed; "
        f"launches {launches}; {res['bytes']} gzip bytes against "
        f"{res['want_bytes']}")
    return res


def phase19_gzip(names, want: np.ndarray, F: int, min_score: int) -> dict:
    """Phase 19 (e): native.gzip_member against Python's zlib on 4 MiB of
    config-5 row text (phase 13's counts formatted as matrix rows), at
    levels 1 and 6, in MB/s (median and best of nine calls each, the two
    interleaved); and whether the library links libdeflate."""
    import zlib
    from niqki_tpu_torch import native
    fmt = native.MatrixFormatter(names, F, min_score)
    text = b""
    row = 0
    while len(text) < (4 << 20):
        text += fmt.format_dense((want[row % len(want)][None] & 0xFFFF)
                                 .astype(np.uint16), row)
        row += 1
    data = text[:4 << 20]

    def zl(level):
        co = zlib.compressobj(level, zlib.DEFLATED, 31)
        return co.compress(data) + co.flush()
    res = {}
    for level in (1, 6):
        fns = {"native": lambda: native.gzip_member(data, level),
               "zlib": lambda: zl(level)}
        times = {tag: [] for tag in fns}
        outs = {}
        for rep in range(9):          # interleaved, the order alternating
            for tag in (sorted(fns) if rep % 2 else sorted(fns)[::-1]):
                t = time.perf_counter()
                outs[tag] = fns[tag]()
                times[tag].append(time.perf_counter() - t)
        for tag, out in outs.items():
            require(zlib.decompress(out, 31) == data,
                    f"{tag} gzip member at level {level} does not inflate "
                    "to its input")
            res[f"{tag} level {level}"] = {
                "MB_per_s": len(data) / statistics.median(times[tag]) / 1e6,
                "MB_per_s_best": len(data) / min(times[tag]) / 1e6,
                "ratio": len(data) / len(out)}
    with open("/proc/self/maps") as f:
        res["libdeflate"] = "libdeflate" in f.read()
    log(f"phase 19 (e): gzip of 4 MiB of config-5 row text: {res}")
    return res


def phase19_wrappers(d: str, spy: "Spy", fof: str, idx15) -> dict:
    """Phase 19 (f): insert_file_whole of phase 4's first 32 files gives
    their rows of phase 4's matrix; match_counts_bitplane at the -Q shape
    (96 x 4096, S = 15, P = 13) equals the plain blocked count, and
    sort_i32_pow2 at 2^23 equals torch.sort."""
    import torch
    from niqki_tpu_torch import SketchIndex
    from niqki_tpu_torch.ops import bcount, count, psort
    with open(fof) as f:
        paths = [os.path.join(d, ln.strip()) for ln in f if ln.strip()][:32]
    idx = SketchIndex(idx15.params)

    def insert():
        for path in paths:
            idx.insert_file_whole(path)
    t = time.time()
    _, il, ishapes = spied_run(spy, insert)
    ins_s = time.time() - t
    require(np.array_equal(idx.matrix(), idx15.matrix()[:32])
            and idx.names == paths and il["psort"] == 32,
            f"insert_file_whole of 32 files: rows differ from phase 4's or "
            f"K1 launches {ishapes}")
    g, gd, q, _, _ = bcount_inputs(13)
    got, bl, bshapes = spied_run(spy, lambda: bcount.match_counts_bitplane(
        q, g, 12))
    qd = torch.from_numpy(np.where(q < 0, -3, q)).cuda()
    plain = count.match_counts_blocked(qd, torch.where(gd < 0, -2, gd),
                                       block_q=8).cpu().numpy()
    require(bl["bcount"] == 1 and np.array_equal(got, plain),
            f"match_counts_bitplane differs from the plain count ({bl})")
    x = torch.from_numpy(np.random.default_rng(SEED + 23).integers(
        -2**31, 2**31, 1 << 23).astype(np.int32)).cuda()
    srt, sl, sshapes = spied_run(spy, lambda: psort.sort_i32_pow2(x))
    require(sl["psort"] == 1 and torch.equal(srt, psort.sort_plain(
        x[None])[0]), f"sort_i32_pow2 differs from torch.sort ({sl})")
    del gd, qd, x, srt
    torch.cuda.empty_cache()
    log(f"phase 19 (f): insert_file_whole of 32 files {ins_s:.2f} s == "
        f"phase 4's rows (K1 {ishapes}); match_counts_bitplane == the "
        f"plain count (K2 {bshapes}); sort_i32_pow2 at 2^23 == torch.sort "
        f"(K1 {sshapes})")
    return {"insert_s": ins_s,
            "shapes": add_shapes(add_shapes(dict(ishapes), bshapes), sshapes)}


def phase_surface(d: str, fof: str, idx15, idx10, p13: dict,
                  spy: "Spy") -> dict:
    """Phase 19: the rest of the JAX package's surface on the card, (a) to
    (f) above. Returns each part's numbers and the launches by shape over
    the phase (``shapes``)."""
    import shutil
    t0 = time.time()
    res = {"a": phase19_sketch(spy)}
    G_ = idx15.G
    last = G_ - (G_ // 96) * 96
    res["b15"] = phase19_all_vs_all(spy, idx15, "bcount", {
        f"P=13 Qb=96 G={G_} L=1024": G_ // 96,
        f"P=13 Qb={last} G={G_} L=1024": 1})
    res["b10"] = phase19_all_vs_all(spy, idx10, "pcount", {
        f"Qb={G_} G={G_} F=1024": 1})
    res["c"] = phase19_config5(spy, p13)
    res["out"] = phase19_outputs(d, spy, idx10)
    p5 = res["c"].pop("params")
    res["e"] = phase19_gzip(res["c"].pop("names"), p13["want"], p5.F,
                            p5.min_score)
    res["f"] = phase19_wrappers(d, spy, fof, idx15)
    shapes = {}
    for part in (res["a"]["shapes"], res["b15"]["shapes"],
                 res["b10"]["shapes"], res["c"]["launches"],
                 res["out"]["shapes"],
                 res["f"]["shapes"]):
        add_shapes(shapes, part)
    require(all(any(k == kernel for k, _ in shapes) for kernel in
                ("psort", "bcount", "pcount")),
            f"phase 19 skipped a kernel: {shapes}")
    shutil.rmtree(p13["dirs"]["v3"])
    res["shapes"] = shapes
    res["wall_s"] = time.time() - t0
    log(f"phase 19: {res['wall_s']:.1f} s; launches by shape {shapes}")
    return res


def kernel_entry(name, source, replaces, launches, stats, mesh,
                 later=(0, 0), **extra):
    """One row of the kernels line; ``later`` holds the row's launches in
    phases 8 and 9, ``mesh`` its launches in phases 16 and 17 and, per
    rank, in phase 18, each the spy's count at the row's shape."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_phase8": later[0], "launches_phase9": later[1],
            "launches_phase16": mesh[0], "launches_phase17": mesh[1],
            "launches_phase18": mesh[2], **stats, **extra}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--phase18-rank"]:
        return phase18_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
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
           (6, 4_600_000, 1 << 23), (512, 52_000, 1 << 16))}
    for e in k1.values():
        log(f"phase 2: K1 psort {e}")
    k2 = {e["path"]: e for e in check_bcount(13, matrix_rows=(768,),
                                             window=True)}
    for e in k2.values():
        log(f"phase 2: K2 bcount {e}")
    log(f"phase 2: K2 bcount {check_bcount(17)[0]}")
    k2["rows"] = check_bcount_rows()
    log(f"phase 2: K2 bcount (96 x 102,400 rows) {k2['rows']}")
    for e in check_bcount_window():
        k2[e["path"]] = e
        log(f"phase 2: K2 bcount ({e['path']}) {e}")
    torch.cuda.empty_cache()
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
        qfof, mutants = write_queries(d, seqs)
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
            q15, wall5, ref5 = phase_query(d, fof, qfof, hidx, spy, 5)
            require(q15["bcount"] > 0 and spy.sparse_hits > 0,
                    "-Q -S 15 did not take the K2 top-k route")
            hidx15, idx15 = hidx, idx
            hidx, m10, idx = phase_matrix(d, fof, spy, 10, 6)
            require(m10["pcount"] == 1 and m10["bcount"] == 0
                    and m10["psort"] > 0,
                    f"-M -S 10 did not count through one K3 launch: {m10}")
            require(idx._device_packed is not None and tuple(
                idx._device_packed.shape) == (G, 512),
                "pair-packed index missing or misshapen")
            q10, _, _ = phase_query(d, fof, qfof, hidx, spy, 7)
            require(q10["pcount"] == 1 and q10["bcount"] == 0
                    and spy.sparse_hits == 0,
                    f"-Q -S 10 did not count through one K3 launch: {q10}")
            idx10 = idx
            del idx
            # ---- phases 8 and 9
            t = time.time()
            allfa, qfa = write_lines_inputs(d, fof, seqs, mutants)
            del seqs, mutants
            log(f"phase 8: wrote {G} genomes as one multi-FASTA + "
                f"{NQ + N_MID + N_SHORT} query records in "
                f"{time.time() - t:.1f} s")
            l8, rows8, idx8, out8 = phase_lines(d, allfa, qfa, hidx15, spy)
            del hidx15
            l9, rows9 = phase_dump(d, idx8, qfa, out8, spy)
            del idx8, out8
            # ---- phases 10 and 11
            c5 = phase_config5(d, spy)
            p11 = phase_dense_overflow(d, spy)
            # ---- phases 12 to 15
            p12 = phase_checkpoints(d, fof, qfof, idx15, idx10, spy)
            p13 = phase_checkpoints_config5(
                d, c5.pop("index"), c5["full"]["times"]["planes_s"])
            p14 = phase_profile(d, fof, qfof, wall5)
            p15 = phase_mxu()
            # ---- phases 16 and 17
            p16 = phase_mesh(d, fof, qfof, allfa, qfa, ref5,
                             p12.pop("ck_v3"), spy, {"m15": m15})
            p17 = phase_mesh_config5(d, c5["fa"], c5["full"]["sha256"], p13,
                                     spy)
            # ---- phase 18
            twins = {"phase 4 -M -S 15": WALLS[4], "phase 5 -I/-Q -S 15":
                     WALLS[5], "phase 6 -M -S 10": WALLS[6],
                     "phase 7 -I/-Q -S 10": WALLS[7],
                     "phase 16 (2x4)": {k: v["wall_s"] for k, v in p16.items()
                                        if "wall_s" in v},
                     "phase 17 -i/-M config 5 (1x4)": p17["wall_s"],
                     "phase 13 v3 load": p13["v3"]["load_s"],
                     "phase 17 v3 restart (1x4)": p17["v3"]["load_s"]}
            p18 = phase_multiprocess(d, fof, qfof, p13,
                                     c5["full"]["sha256"],
                                     {"m15": m15, "walls": twins})
            # ---- phase 19
            p19 = phase_surface(d, fof, idx15, idx10, p13, spy)
            del idx15, idx10
        finally:
            spy.close()
    torch.cuda.empty_cache()
    s18 = check_shards(8, 1)
    for key, e in s18.items():
        log(f"phase 18: {key} per shard at 1x8 {e}")
    k1_one = check_psort(2, LEN, 1 << 17)
    log(f"phase 19: K1 psort at insert_file_whole's shape (2 x 2^17) "
        f"{k1_one}")
    k1_dev = check_psort(32, LEN, 1 << 17)
    log(f"phase 16: K1 psort per device (32 x 2^17) {k1_dev}")
    # -i/-l's most launched shapes a device (phase 16's launches by shape)
    k1_dev_lines = {N: check_psort(B, n, 1 << N)
                    for B, n, N in ((24, LEN, 17), (48, 52_000, 16))}
    for N, e in k1_dev_lines.items():
        log(f"phase 16: K1 psort per device, lines mode (2^{N}) {e}")

    k1_src = ("niqki_tpu_torch/csrc/psort.cu", "niqki_tpu/ops/psort.py:125")
    k2_src = ("niqki_tpu_torch/csrc/bcount.cu", "niqki_tpu/ops/bcount.py:103")
    k3_src = ("niqki_tpu_torch/csrc/pcount.cu", "niqki_tpu/ops/pcount.py:52")
    ecoli = "not on the smoke's main path (E. coli-sized records)"
    off_path = ("not on the main path (phase 2 only): the port counts a "
                "whole call in one launch")
    def k1_later(n):
        return rows8.get(n, 0), rows9.get(n, 0)
    l14 = p14["launches"]
    sym10, full10 = c5["sym"]["launches"], c5["full"]["launches"]
    # phases 16 and 17 by (kernel, shape): every run of the phase
    sh16 = {}
    for r in p16.values():
        if "shapes" in r:
            add_shapes(sh16, r["shapes"])
    sh17 = add_shapes(dict(p17["shapes"]), p17["restart_shapes"])
    # phase 18 by (kernel, shape) on each rank: every path of the rank
    sh18 = [{} for _ in range(RANKS)]
    for r, rk in enumerate(p18["ranks"]):
        for e in rk["paths"].values():
            add_shapes(sh18[r], {tuple(k.split("|", 1)): v
                                 for k, v in e["shapes"].items()})
    log(f"phases 16-18: launches by shape {sh16} / {sh17} / {sh18}")

    def mesh(kernel, stats):
        key = (kernel, stats["shape"])
        return sh16.get(key, 0), sh17.get(key, 0), {
            f"rank{r}": sh18[r].get(key, 0) for r in range(RANKS)}

    def in18(kernel, stats):
        return sum(mesh(kernel, stats)[2].values())

    def in19(kernel, stats):
        return p19["shapes"].get((kernel, stats["shape"]), 0)

    def in16(tag, kernel, stats):
        return p16[tag]["shapes"].get((kernel, stats["shape"]), 0)
    sh = p16["shards"]
    on11 = p11["on"]["launches"]
    N5, widths5, _ = sym_widths(G5)
    print(json.dumps({"kernels": [
        kernel_entry("psort sort_i32_pow2_batch (K1, 256 x 2^17)", *k1_src,
                     m15["psort"], k1[256], mesh("psort", k1[256]),
                     launches_from="phase 4, -M -S 15 (launches_phase12: "
                     "phase 12's --load-sharded -Q at S=15 and S=10; "
                     "launches_phase14: the profiled -I/-Q)",
                     later=k1_later(1 << 17),
                     launches_phase12=p12["a"]["psort"] + p12["c"]["psort"],
                     launches_phase14=l14["psort"]),
        kernel_entry("psort sort_i32_pow2_batch (K1, 512 x 2^16, lines "
                     "mode)", *k1_src, rows8.get(1 << 16, 0), k1[512],
                     mesh("psort", k1[512]),
                     launches_from="phase 8, -i/-l -S 15: the 40-65 kb "
                     "contigs", later=k1_later(1 << 16)),
        kernel_entry("psort sort_i32_pow2_batch (K1, 1 x 2^23)", *k1_src,
                     p19["a"]["shapes"].get(("psort", k1[1]["shape"]), 0),
                     k1[1], mesh("psort", k1[1]),
                     launches_phase19=in19("psort", k1[1]),
                     launches_from="phase 19 (a), sketch_codes of six "
                     "4.64 Mbp records (launches_phase19: with (f)'s "
                     "sort_i32_pow2)"),
        kernel_entry("psort sort_i32_pow2_batch (K1, 6 x 2^23)", *k1_src, 0,
                     k1[6], mesh("psort", k1[6]), launches_from=ecoli),
        kernel_entry("psort sort_i32_pow2_batch (K1, 2 x 2^17)", *k1_src,
                     p19["f"]["shapes"].get(("psort", k1_one["shape"]), 0),
                     k1_one, mesh("psort", k1_one),
                     launches_phase19=in19("psort", k1_one),
                     launches_from="phase 19 (f), insert_file_whole of 32 "
                     "genomes of 100 kb, one launch each (a batch of one "
                     "record padded to two rows)"),
        kernel_entry("bcount _bcount_call (K2, -M window at G = 4096: "
                     "768 x 4608 of the extended planes)", *k2_src,
                     m15["bcount"], k2["-M window"],
                     mesh("bcount", k2["-M window"]),
                     launches_phase12=p12["b"]["bcount"],
                     launches_from="phase 4, -M -S 15: the symmetric "
                     "sweep's 6 windows of 6 blocks; phase 12: the same "
                     "sweep of the reloaded index"),
        kernel_entry("bcount _bcount_call (K2, -M shape)", *k2_src, 0,
                     k2["-M"], mesh("bcount", k2["-M"]),
                     launches_from="not on the smoke's main path "
                     "at G = 4096: the full sweep's block (SYM=off)"),
        kernel_entry("bcount _bcount_call (K2, -Q shape)", *k2_src,
                     q15["bcount"], k2["-Q"], mesh("bcount", k2["-Q"]),
                     later=(l8["bcount"], l9["bcount"]),
                     launches_phase12=p12["a"]["bcount"],
                     launches_phase14=l14["bcount"],
                     launches_phase19=in19("bcount", k2["-Q"]),
                     launches_from="phase 5, -I/-Q -S 15; phases 8 and 9: "
                     "-l in 96-query blocks; phase 12: --load-sharded -Q; "
                     "phase 14: the profiled -I/-Q; phase 19: "
                     "all_vs_all_counts at S=15 (42 blocks of 96, its 64-row "
                     "last block at a shape of its own) and "
                     "match_counts_bitplane"),
        kernel_entry("bcount _bcount_call (K2, 96 x 102,400 x 128 lanes, "
                     "P=13: config 5's counts of 96 rows)", *k2_src,
                     in19("bcount", p19["c"]["k2_rows"]),
                     p19["c"]["k2_rows"],
                     mesh("bcount", p19["c"]["k2_rows"]),
                     launches_phase13=p13["launches"],
                     launches_from="phase 19 (c) and (d): "
                     "ShardedIndex.hits of one query (padded to 96 rows) "
                     "and the 96 counts of the reloaded config-5 index "
                     "(launches_phase13: phase 13's reloads, v3 and v2)"),
        kernel_entry("bcount _bcount_call (K2, 1 x 102,400 x 128 lanes, "
                     "P=13: hits of one query against config 5)", *k2_src,
                     in19("bcount", p19["c"]["k2_hit"]),
                     p19["c"]["k2_hit"],
                     mesh("bcount", p19["c"]["k2_hit"]),
                     launches_from="phase 19 (c), SketchIndex.hits of 9 "
                     "queries after the v3 restart"),
        kernel_entry("bcount _bcount_call (K2, 96 x 102,400 rows)", *k2_src,
                     0, k2["rows"], mesh("bcount", k2["rows"]),
                     launches_from="not on the main path (phase 2 only)"),
        kernel_entry("bcount _bcount_call (K2, config-5 window, block 0: "
                     f"768 x {widths5[0] * 768} x 128 lanes, P=13)", *k2_src,
                     sym10["bcount"], k2["config-5 window, block 0"],
                     mesh("bcount", k2["config-5 window, block 0"]),
                     launches_phase10_full=full10["bcount"],
                     launches_phase11=on11["bcount"],
                     launches_phase13=p13["launches"],
                     k2_device_ms_phase10=c5["sym"]["k2"]["device_ms"],
                     k2_device_ms_phase10_full=c5["full"]["k2"]["device_ms"],
                     launches_from="phase 10, -i/-M -S 12 at G = 102,400 "
                     f"(BASELINE config 5), symmetric sweep: {N5} windows "
                     f"of {widths5[-1] * 768} to {widths5[0] * 768} "
                     "columns (launches_phase10_full: the full sweep's; "
                     "launches_phase11: phase 11's symmetric sweep; "
                     "launches_phase13: the counts of 96 rows against the "
                     "two reloaded config-5 indexes, 96 x 102,400)"),
        kernel_entry("bcount _bcount_call (K2, config-5 window, block "
                     f"{N5 // 2}: 768 x {widths5[N5 // 2] * 768} x 128 "
                     "lanes, P=13)", *k2_src, 0,
                     k2[f"config-5 window, block {N5 // 2}"],
                     mesh("bcount", k2[f"config-5 window, block {N5 // 2}"]),
                     launches_from="one of phase 10's window widths: its "
                     "launches are counted in the row above"),
        *[kernel_entry(f"bcount _bcount_call (K2, {path} shape at S={S_}, "
                       f"{k2[f'{path} S={S_}']['shape']})", *k2_src, 0,
                       k2[f"{path} S={S_}"],
                       mesh("bcount", k2[f"{path} S={S_}"]),
                       launches_from="not on the main path (phase 2 only):"
                       " S <= 11 counts through K3")
          for S_ in (10, 11) for path in ("-M", f"-M {G} rows", "-Q")],
        *[kernel_entry(f"pcount _count_call (K3, shape {key})", *k3_src, 0,
                       k3[key], mesh("pcount", k3[key]),
                       launches_from=off_path) for key in "abc"],
        kernel_entry("pcount _count_call (K3, shape d, the -M call)",
                     *k3_src, m10["pcount"], k3["d"], mesh("pcount", k3["d"]),
                     launches_phase19=in19("pcount", k3["d"]),
                     launches_from="phase 6, -M -S 10 (launches_phase19: "
                     "all_vs_all_counts at S=10 and the -M -S 10 at gzip "
                     "level 1)"),
        kernel_entry("pcount _count_call (K3, shape e, the -Q call)",
                     *k3_src, q10["pcount"], k3["e"], mesh("pcount", k3["e"]),
                     later=(l8["pcount"], l9["pcount"]),
                     launches_phase12=p12["c"]["pcount"],
                     launches_from="phase 7, -I/-Q -S 10; phase 12: "
                     "--load-sharded -Q at S=10"),
        kernel_entry("pcount _count_call (K3, shape f, the -M call at S=11)",
                     *k3_src, 0, k3["f"], mesh("pcount", k3["f"]),
                     launches_from="not on the main path (phase 2 only): "
                     "the smoke's main path runs S=10"),
        kernel_entry("psort sort_i32_pow2_batch (K1, 32 x 2^17, per device "
                     "at --mesh 2x4)", *k1_src,
                     in16("-M -S 15", "psort", k1_dev), k1_dev,
                     mesh("psort", k1_dev),
                     launches_from="phase 16, -M -S 15 on 2x4: each "
                     "256-record batch split over 8 devices "
                     "(launches_phase16: every phase 16 run at this shape)"),
        *[kernel_entry(f"psort sort_i32_pow2_batch (K1, {e['shape']}, per "
                       "device at --mesh 2x4, lines mode)", *k1_src,
                       in16("-i/-l", "psort", e), e, mesh("psort", e),
                       launches_from="phase 16, -i/-l on 2x4: "
                       + ("the -i ingest's batches of genomes" if N == 17
                          else "the 40-65 kb contigs")
                       + " split over 8 devices (launches_phase16: every "
                       "phase 16 run at this shape)")
          for N, e in k1_dev_lines.items()],
        kernel_entry("bcount _bcount_call (K2, per shard at --mesh 2x4, -M "
                     "block: 768 x 1024 x 1024 lanes, P=13)", *k2_src,
                     in16("-M -S 15", "bcount", sh["K2 -M"]), sh["K2 -M"],
                     mesh("bcount", sh["K2 -M"]),
                     launches_from="phase 16, -M -S 15 on 2x4: 6 blocks x "
                     "4 tp shards (launches_phase16: every phase 16 run at "
                     "this shape)"),
        kernel_entry("bcount _bcount_call (K2, per shard at --mesh 2x4, -Q: "
                     "96 x 1024 x 1024 lanes, P=13)", *k2_src,
                     in16("-I/-Q -S 15", "bcount", sh["K2 -Q"]), sh["K2 -Q"],
                     mesh("bcount", sh["K2 -Q"]),
                     launches_from="phase 16, -I/-Q -S 15 on 2x4: one "
                     "96-query block a device (launches_phase16: every "
                     "phase 16 run at this shape, -l's blocks among them)"),
        kernel_entry("bcount _bcount_call (K2, per shard at --mesh 1x4 over "
                     "config 5: 768 x 25,600 x 128 lanes, P=13)", *k2_src,
                     p17["shapes"].get(("bcount",
                                        sh["K2 config-5 block"]["shape"]), 0),
                     sh["K2 config-5 block"],
                     mesh("bcount", sh["K2 config-5 block"]),
                     launches_from="phase 17, -i/-M -S 12 at G = 102,400 on "
                     "1x4: 134 blocks x 4 shards"),
        kernel_entry("pcount _count_call (K3, per shard at --mesh 2x4, -M "
                     "S=10: 2048 x 1024 x 512 lanes)", *k3_src,
                     in16("-M -S 10", "pcount", sh["K3 -M"]), sh["K3 -M"],
                     mesh("pcount", sh["K3 -M"]),
                     launches_from="phase 16, -M -S 10 on 2x4: one launch a "
                     "device (launches_phase16: every phase 16 run at this "
                     "shape)"),
        kernel_entry("pcount _count_call (K3, per shard at --mesh 2x4, -Q "
                     "S=10: 64 x 1024 x 512 lanes)", *k3_src,
                     in16("-I/-Q -S 10", "pcount", sh["K3 -Q"]), sh["K3 -Q"],
                     mesh("pcount", sh["K3 -Q"]),
                     launches_from="phase 16, -I/-Q -S 10 on 2x4: 96 "
                     "queries padded to 128, 64 a device (launches_phase16: "
                     "every phase 16 run at this shape)"),
        kernel_entry("bcount _bcount_call (K2, per shard at --mesh 1x4 over "
                     "config 5, the restart's counts: 96 x 25,600 x 128 "
                     "lanes, P=13)", *k2_src,
                     sh17.get(("bcount", sh["K2 config-5 -Q"]["shape"]), 0),
                     sh["K2 config-5 -Q"],
                     mesh("bcount", sh["K2 config-5 -Q"]),
                     launches_from="phase 17, the v3 and v2 restarts' "
                     "counts of 96 rows: one launch a shard each"),
        *[kernel_entry(f"{kname} (K{k}, per shard at 1x8 over two gloo "
                       f"ranks, {what})", *src, in18(kernel, s18[key]),
                       s18[key], mesh(kernel, s18[key]),
                       launches_from=f"phase 18, {where} (launches: both "
                       "ranks; launches_phase18: each rank)")
          for kname, k, kernel, src, key, what, where in (
              ("bcount _bcount_call", 2, "bcount", k2_src, "K2 -M",
               "-M block: 768 x 512 x 1024 lanes, P=13",
               "-M -S 15 under 1x8: 6 blocks x 4 shards a rank"),
              ("bcount _bcount_call", 2, "bcount", k2_src, "K2 -Q",
               "-Q: 96 x 512 x 1024 lanes, P=13",
               "-I/-Q -S 15 under 1x8: one 96-query block a device"),
              ("bcount _bcount_call", 2, "bcount", k2_src,
               "K2 config-5 block",
               "config 5's block: 768 x 12,800 x 128 lanes, P=13",
               "-M of config 5 restarted under 1x8: 134 blocks x 4 "
               "shards a rank"),
              ("bcount _bcount_call", 2, "bcount", k2_src, "K2 config-5 -Q",
               "config 5's restart counts: 96 x 12,800 x 128 lanes, P=13",
               "the counts of 96 rows after the 1x8 restart"),
              ("pcount _count_call", 3, "pcount", k3_src, "K3 -M",
               "-M S=10: 4096 x 512 x 512 lanes",
               "-M -S 10 under 1x8: one launch a device"),
              ("pcount _count_call", 3, "pcount", k3_src, "K3 -Q",
               "-Q S=10: 128 x 512 x 512 lanes",
               "-I/-Q -S 10 under 1x8: 96 queries padded to 128, one "
               "launch a device"))],
    ], "build_s": build_s, "card": smi,
        "checkpoints_config5": {k: p13[k] for k in ("v3", "v2", "pack_s",
                                                      "planes_s")},
        "profile": {k: p14[k] for k in ("wall_s", "wall5_s", "trace_bytes")},
        "mxu": p15,
        "mesh_phase16": {k: {kk: v[kk] for kk in ("wall_s", "launches")}
                         for k, v in p16.items() if "launches" in v and
                         "wall_s" in v},
        "mesh_restart_phase16": {k: v for k, v in p16["restart"].items()
                                 if k != "shapes"},
        "dryrun_phase16": {k: v for k, v in p16["dryrun"].items()
                           if k != "shapes"},
        "mesh_config5_phase17": {k: p17[k] for k in (
            "wall_s", "times", "sweep", "peak_device_gib", "launches",
            "v3", "v2")},
        "multiprocess_phase18": {
            "wall_s": p18["wall_s"], "one_process_walls": twins,
            "gloo_cuda_probe": p18["ranks"][0]["probe"],
            "ranks": [{tag: {k: e[k] for k in ("wall_s", "launches",
                                                 "collectives",
                                                 "peak_device_gib")}
                       for tag, e in rk["paths"].items()}
                      for rk in p18["ranks"]]},
        "surface_phase19": {
            "wall_s": p19["wall_s"],
            "sketch_codes": {k: p19["a"][k] for k in (
                "dispatch_ms", "k1_ms", "k1_share", "host_check_s")},
            "all_vs_all_s": {"S=15": p19["b15"]["wall_s"],
                             "S=10": p19["b10"]["wall_s"]},
            "config5": {k: p19["c"][k] for k in ("load_s", "hits_s",
                                                 "counts_s")},
            "gzip": p19["e"],
            "gzip_level1_output": {k: p19["out"][k] for k in (
                "wall_s", "bytes", "want_bytes")},
            "insert_file_whole_s": p19["f"]["insert_s"]},
        "launches_by_shape": {
            "phase16": {f"{k} {shp}": n for (k, shp), n in sh16.items()},
            "phase17": {f"{k} {shp}": n for (k, shp), n in sh17.items()},
            "phase18": [{f"{k} {shp}": n for (k, shp), n in part.items()}
                        for part in sh18],
            "phase19": {f"{k} {shp}": n
                        for (k, shp), n in p19["shapes"].items()}}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
