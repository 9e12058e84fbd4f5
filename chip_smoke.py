#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (niqki_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     niqki_tpu_torch/csrc (timed); the native host library must load.
  2. each kernel against its plain PyTorch version on the card, exactly, at
     the shapes the main path gives it, with median times of both:
     K1 (psort) at 256 x 2^17 (a batch of 100 kb records) and 1 x 2^23
     (an E. coli-sized record); K2 (bcount) against 4096 index rows of
     1024 lanes at the -M shape (768 index rows re-encoded as queries, one
     MATRIX_BLOCK of the self-join, P = 13) and at the -Q shape (96 packed
     queries, P = 13 and 17).
  3. the golden matrix: -M tests/fixtures/fof_tiny.txt -S 16 -K 21 through
     the self-join must equal tests/fixtures/matrix_s16_tiny.gz.
  4. the main path at full size: -M over 4096 synthetic 100 kb genomes
     (128 clusters of 32 at 2% point mutation) with the golden sketch
     configuration (K=31, S=15, W=12, H=4) and -J 0.05. The sketch matrix
     must equal the host-native sketches, 96 sampled output rows must equal
     rows formatted from host counts, and both kernels must have launched.
  5. -I/-Q: 96 query genomes (1% mutants of index genomes) against that
     index; the output must equal the host-native hits.

The second line from the end is a JSON object with, for each kernel and
main-path shape, its launches in the run that gives it that shape (phase 4
for -M, phase 5 for -Q), its error and times; the last line names the
device. Without a CUDA device, or without the port's package beside it,
the script fails before printing either. It imports nothing of JAX and no
module of the JAX package by name: the host-native reference comes through
the port (``niqki_tpu_torch.native``, ``SketchIndex`` under
NIQKI_TPU_SKETCH=host).
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


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.time() - T0:7.1f}s] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gz_bytes(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


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


def check_psort(B: int, n_bases: int, Np: int) -> dict:
    import torch
    from niqki_tpu_torch.ops import psort
    keys = record_keys(B, n_bases, Np, seed=B)
    got = psort.sort_i32_pow2_batch(keys)
    want = psort.sort_plain(keys)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    require(err == 0 and torch.equal(got, want),
            f"K1 differs from torch.sort at {B}x{Np}")
    ms = time_cuda(lambda: psort.sort_i32_pow2_batch(keys))
    plain_ms = time_cuda(lambda: psort.sort_plain(keys))
    return {"shape": f"{B}x{Np}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def check_bcount(P: int, matrix_shape: bool = False) -> list[dict]:
    """K2 against its plain version over 4096 index rows of 1024 lanes
    (S=15): at the -Q shape (96 queries packed from fingerprints, as
    match_counts_planes ships them) and, with ``matrix_shape``, at the -M
    shape (MATRIX_BLOCK index rows re-encoded as queries, as the self-join
    sweep launches it)."""
    import torch
    from niqki_tpu_torch.ops import bcount
    W, F, Qb = P - 1, 32768, bcount.BLOCK_Q
    rng = np.random.default_rng(P)
    g = rng.integers(0, 1 << W, (G, F), dtype=np.int32)
    g[:64] = g[0]                                   # one cluster of 64
    g[rng.random((G, F)) < 0.01] = -2
    q = g[rng.choice(G, Qb, replace=False)].copy()
    q[:8] = g[0]
    q[rng.random(q.shape) < 0.05] = -3
    xp = bcount.pack_bitplanes(torch.from_numpy(g).cuda(), W=W, query=False)
    shapes = [("-Q", bcount.pack_bitplanes(torch.from_numpy(q).cuda(), W=W,
                                           query=True))]
    if matrix_shape:
        shapes.append(("-M", bcount._planes_as_queries(
            xp, 0, bcount.MATRIX_BLOCK).contiguous()))
    out = []
    for path, qp in shapes:
        got = bcount._bcount_call(qp, xp)
        want = bcount._bcount_plain(qp, xp)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        require(err == 0 and torch.equal(got, want),
                f"K2 differs from its plain version at P={P}, {path} shape")
        require(int(got.max()) > F // 2, "K2 check saw no real matches")
        ms = time_cuda(lambda: bcount._bcount_call(qp, xp))
        plain_ms = time_cuda(lambda: bcount._bcount_plain(qp, xp), reps=5,
                             warmup=1)
        out.append({"path": path, "shape": f"P={P} Qb={qp.shape[1]} G={G} "
                    f"L={F // 32}", "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms})
    return out


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
    """Times and records calls of the port's index methods during a CLI
    run (the CLI builds its index internally)."""

    def __init__(self):
        import torch
        from niqki_tpu_torch import engine, index
        self.times: dict[str, float] = {}
        self.index = None
        self.sparse_hits = 0
        cls = index.SketchIndex
        self._orig = {"sketch_files": cls.sketch_files,
                      "_planes": cls._planes,
                      "pretty_hits_batch": cls.pretty_hits_batch,
                      "sweep": engine._query_matrix_selfjoin}
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
            return timed("ingest_s", spy._orig["sketch_files"])(
                self_, paths, *a, **k)

        def planes(self_):
            if self_._device_planes is not None:
                return self_._device_planes

            def build():
                out = spy._orig["_planes"](self_)
                if out.is_cuda:      # time the device work, not the enqueue
                    torch.cuda.synchronize(out.device)
                return out
            return timed("planes_s", build)()

        def pretty(self_, q, headers):
            buf = spy._orig["pretty_hits_batch"](self_, q, headers)
            spy.sparse_hits += buf is not None
            return buf

        cls.sketch_files = sketch_files
        cls._planes = planes
        cls.pretty_hits_batch = pretty
        engine._query_matrix_selfjoin = timed("sweep_s", self._orig["sweep"])

    def close(self):
        from niqki_tpu_torch import engine, index
        cls = index.SketchIndex
        cls.sketch_files = self._orig["sketch_files"]
        cls._planes = self._orig["_planes"]
        cls.pretty_hits_batch = self._orig["pretty_hits_batch"]
        engine._query_matrix_selfjoin = self._orig["sweep"]


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


def phase_matrix(d: str, fof: str, spy: "Spy"):
    """-M at full size; returns (host reference index, launches)."""
    import torch
    from niqki_tpu_torch import SketchParams, cli, kernels, native
    p = SketchParams(lF=S, min_fract=0.05)
    out = os.path.join(d, "m.gz")
    os.environ["NIQKI_TPU_MATRIX_STATS"] = "1"
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    rc = cli.main(["-M", fof, "-S", str(S), "-J", "0.05", "-O", out])
    launches = dict(kernels.LAUNCHES)
    wall = time.time() - t
    del os.environ["NIQKI_TPU_MATRIX_STATS"]
    require(rc == 0, "-M rc")
    idx = spy.index
    require(idx is not None and idx.G == G, "-M did not index G genomes")
    mem = (torch.cuda.max_memory_allocated() / 2**30
           if torch.cuda.is_available() else float("nan"))
    log(f"phase 4: -M wall {wall:.2f} s; ingest "
        f"{spy.times.get('ingest_s', 0):.2f} s, planes "
        f"{spy.times.get('planes_s', 0):.3f} s, sweep "
        f"{spy.times.get('sweep_s', 0):.2f} s; launches {launches}; peak "
        f"device memory {mem:.2f} GiB")
    require(idx._device_planes is not None
            and tuple(idx._device_planes.shape) == (13, G, p.F // 32),
            "index planes missing or misshapen")
    t = time.time()
    hidx = host_index(fof, p)
    log(f"phase 4: host-native reference sketches in {time.time() - t:.1f} s")
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
    log(f"phase 4: sketch matrix == host-native; 96 sampled rows == host "
        f"counts ({cells} cells >= J)")
    return hidx, launches


def phase_query(d: str, fof: str, qfof: str, hidx, spy: "Spy") -> dict:
    from niqki_tpu_torch import cli, kernels, native
    p = hidx.params
    qout = os.path.join(d, "q.gz")
    kernels.reset_launches()
    spy.sparse_hits = 0
    t = time.time()
    rc = cli.main(["-I", fof, "-Q", qfof, "-S", str(S), "-J", "0.05",
                   "-O", qout])
    wall = time.time() - t
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, "-I/-Q rc")
    require(spy.sparse_hits > 0, "-Q did not take the K2 top-k route")
    with open(qfof) as f:
        qpaths = [ln.rstrip("\n") for ln in f if ln.strip()]
    hq = host_index(qfof, p)
    fmt = native.HitsFormatter(hidx.names, p.F, p.min_score)
    want = fmt.format(native.count_eq(hq.matrix(), hidx._stored(),
                                      p.fingerprint_range), qpaths)
    got = gz_bytes(qout)
    require(got == want, "-Q hits differ from host-native hits")
    log(f"phase 5: -I/-Q wall {wall:.2f} s ({NQ} queries, "
        f"{got.count(b':')} hits) == host-native; launches {launches}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # the port first: its import keeps the JAX package's compile-cache
    # set-up away from HOME
    from niqki_tpu_torch import ensure_native, kernels, native

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
    require(ensure_native() and native.available(),
            "native host library did not build")

    # ---- phase 2
    k1 = check_psort(256, LEN, 1 << 17)
    log(f"phase 2: K1 psort {k1}")
    log(f"phase 2: K1 psort {check_psort(1, 4_600_000, 1 << 23)}")
    k2 = {e["path"]: e for e in check_bcount(13, matrix_shape=True)}
    for e in k2.values():
        log(f"phase 2: K2 bcount {e}")
    log(f"phase 2: K2 bcount {check_bcount(17)[0]}")

    with tempfile.TemporaryDirectory(prefix="niqki_smoke_") as d:
        # ---- phase 3
        launches = phase_golden(d)
        require(min(launches.values()) > 0,
                f"golden run skipped a kernel: {launches}")
        log(f"phase 3: golden matrix byte-identical, launches {launches}")
        # ---- phases 4 and 5
        t = time.time()
        fof, seqs = write_genomes(d)
        qfof = write_queries(d, seqs)
        log(f"phase 4: wrote {G} genomes of {LEN} bp + {NQ} queries in "
            f"{time.time() - t:.1f} s")
        spy = Spy()
        try:
            hidx, main_launches = phase_matrix(d, fof, spy)
            require(min(main_launches.values()) > 0,
                    f"main path skipped a kernel: {main_launches}")
            q_launches = phase_query(d, fof, qfof, hidx, spy)
            require(q_launches["bcount"] > 0, "-Q launched no K2")
        finally:
            spy.close()

    print(json.dumps({"kernels": [
        {"name": "psort sort_i32_pow2_batch (K1)", "route": "cuda",
         "source": "niqki_tpu_torch/csrc/psort.cu",
         "replaces": "niqki_tpu/ops/psort.py:124",
         "launches": main_launches["psort"], **k1},
        *[{"name": f"bcount _bcount_call (K2, {path} shape)", "route": "cuda",
           "source": "niqki_tpu_torch/csrc/bcount.cu",
           "replaces": "niqki_tpu/ops/bcount.py:102",
           "launches": launches["bcount"], **k2[path]}
          for path, launches in (("-M", main_launches), ("-Q", q_launches))],
    ], "build_s": build_s, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
