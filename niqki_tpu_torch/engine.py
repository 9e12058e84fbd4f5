"""File-level entry points of the port: the -I/-M fof ingest, the -i
per-record ingest, the -M all-vs-all matrix, the -Q whole-genome hit query
and the -l per-record hit query.

The port's counterpart of ``niqki_tpu/engine.py``, with the reference's
path rules: -I/-M resolve fof entries from the fof's own directory, -Q from
the CWD; names are the fof lines as written (the header lines under -i and
-l); missing entries are skipped; ids follow fof line order.

The matrix self-join runs on the index's own bit-planes: each block is a
device-side re-encode + count (K2) + uint16 wrap + top-k, and only
surviving (count, gid) pairs come back to the native formatter. Indexes
outside the bit-plane gate (S <= 11) take the dense loop, whose counts come
from ``SketchIndex.counts`` (K3 at G >= 4096).

Routing divergence: the JAX package's ``auto`` takes the symmetric
triangular sweep off its TPU tunnel; the port runs the full sweep, which
writes the same bytes. ``NIQKI_TPU_MATRIX_SYM=on`` is refused until the
symmetric sweep is ported.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import hostmem, native
from .index import SketchIndex, hits_from_counts_batch
from .io.fasta import exists, read_fof, read_query_fof, read_records
from .io.writers import (GzTextWriter, write_binary_hits, write_matrix_header,
                         write_matrix_row, write_pretty_hits)
from .ops import bcount

__all__ = ["insert_fof_whole", "insert_file_lines", "query_fof_whole",
           "query_file_lines", "query_matrix", "query_file_matrix",
           "query_fof_matrix"]


def _fof_entries(fof_path: str):
    """Yield (name_as_written, resolved_path) for existing entries, resolved
    from the fof's directory (the reference's -I/-M chdir)."""
    base = os.path.dirname(os.path.abspath(fof_path))
    for line in read_fof(fof_path):
        path = line if os.path.isabs(line) else os.path.join(base, line)
        if exists(path):
            yield line, path


def insert_fof_whole(index: SketchIndex, fof_path: str) -> None:
    entries = list(_fof_entries(fof_path))
    sketches = index.sketch_files([p for _, p in entries])
    for (name, _), sk in zip(entries, sketches):
        index.insert_sketch(sk, name)


def insert_file_lines(index: SketchIndex, path: str) -> None:
    """-i: each record of one FASTA/FASTQ file is an entry. (The reference
    chdirs to the file's directory and opens its basename there: the same
    file.)"""
    index.insert_file_lines(path)


def _stack_sketches(sks) -> np.ndarray:
    q = hostmem.big_empty((len(sks), len(sks[0])), np.int32)
    for i, s in enumerate(sks):
        q[i] = s
    return q


def query_fof_whole(index: SketchIndex, fof_path: str, out: GzTextWriter,
                    pretty: bool = True, batch: int = 96) -> None:
    """-Q: each fof entry (resolved from the CWD) is sketched whole and
    queried. Chunk i+1 sketches on a thread while chunk i counts and
    formats; rows stream in fof order. Pretty rows take the sparse K2
    top-k route when the index is eligible, else dense counts."""
    lines = [ln for ln in read_query_fof(fof_path) if exists(ln)]
    chunks = [lines[lo:lo + batch] for lo in range(0, len(lines), batch)]

    def process(chunk, sks):
        if pretty and sks:
            buf = index.pretty_hits_batch(_stack_sketches(sks), chunk)
            if buf is not None:
                out.write(buf)
                return
        counts = index.counts(_stack_sketches(sks)) if sks else []
        for name, c in zip(chunk, counts):
            hits = index.hits_from_counts(c)
            if pretty:
                write_pretty_hits(out, name, hits, index.names,
                                  index.params.F)
            else:
                write_binary_hits(out, name, hits)

    with ThreadPoolExecutor(1) as pre:
        fut = pre.submit(index.sketch_files, chunks[0]) if chunks else None
        for i, chunk in enumerate(chunks):
            sks = fut.result()
            fut = pre.submit(index.sketch_files, chunks[i + 1]) \
                if i + 1 < len(chunks) else None
            process(chunk, sks)


def query_file_lines(index: SketchIndex, path: str, out: GzTextWriter,
                     pretty: bool = True, batch: int = 1 << 15) -> None:
    """-l: each record of one file is a query named by its header; rows
    stream in file order. Records are sketched and counted a chunk of
    ``batch`` records at a time (halved while batch * G > 2^28, which
    bounds the dense (batch, G) counts). Pretty rows take the sparse K2
    top-k route when the index is eligible, else dense counts through the
    native formatter; binary rows take hits_from_counts_batch."""
    if index.backend == "numpy":
        for header, seq in read_records(path, index.params.K):
            hits = index.hits_from_counts(
                index.counts(index.sketch_records([seq])[None, :])[0])
            if pretty:
                write_pretty_hits(out, header, hits, index.names,
                                  index.params.F)
            else:
                write_binary_hits(out, header, hits)
        return
    while batch > (1 << 11) and batch * max(index.G, 1) > (1 << 28):
        batch //= 2
    fmt = None
    if pretty and native.available():
        fmt = native.HitsFormatter(index.names, index.params.F,
                                   index.params.min_score)
    for part, q in index.query_sketch_stream(
            index._iter_packed_with_headers(path), batch):
        headers = [r[0] for r in part]
        if fmt is not None and len(q):
            buf = index.pretty_hits_batch(q, headers)
            if buf is None:
                buf = fmt.format(index.counts(q), headers)
            out.write(buf)
            continue
        counts = index.counts(q) if len(q) else \
            np.zeros((0, index.G), np.int32)
        all_hits = hits_from_counts_batch(counts, index.params.min_score)
        for r, hits in zip(part, all_hits):
            if pretty:
                write_pretty_hits(out, r[0], hits, index.names,
                                  index.params.F)
            else:
                write_binary_hits(out, r[0], hits)


class _ParallelMatrixFmt:
    """Row-chunked parallel front of native.MatrixFormatter (the C++
    formatter releases the GIL). Each worker owns its formatter, whose
    output buffer is not shareable; chunks write to ``out`` in row
    order."""

    def __init__(self, names, F: int, min_score: int, threads: int = 4):
        self._fmts = [native.MatrixFormatter(names, F, min_score)
                      for _ in range(threads)]
        self._pool = ThreadPoolExecutor(threads)

    def _write(self, out, method: str, arrays, row0: int) -> None:
        n = len(arrays[0])
        if n <= 96:
            out.write(getattr(self._fmts[0], method)(*arrays, row0))
            return
        k = len(self._fmts)
        chunk = -(-n // k)
        futs = [self._pool.submit(getattr(self._fmts[t], method),
                                  *[a[t * chunk:(t + 1) * chunk]
                                    for a in arrays], row0 + t * chunk)
                for t in range(k) if t * chunk < n]
        for f in futs:
            out.write(f.result())

    def write_sparse(self, out, vals, idx, row0: int) -> None:
        self._write(out, "format_sparse", (vals, idx), row0)

    def write_dense(self, out, counts, row0: int) -> None:
        self._write(out, "format_dense", (counts,), row0)

    def close(self):
        self._pool.shutdown()


def _matrix_selfjoin_mode(index: SketchIndex) -> bool:
    """NIQKI_TPU_MATRIX = auto|selfjoin|dense; auto takes the self-join at
    G >= 2048 (the JAX package's gates, kept as they are)."""
    mode = os.environ.get("NIQKI_TPU_MATRIX", "auto")
    if mode == "dense":
        return False
    p = index.params
    ok = (index.backend != "numpy" and native.available()
          and bcount.available(p.F, p.W))
    if mode == "selfjoin":
        if not ok:
            raise RuntimeError("NIQKI_TPU_MATRIX=selfjoin needs a device "
                               "backend, the native lib, and bcount's "
                               "shape gate (F%4096==0, 1<=W<=30)")
        return True
    return ok and index.G >= 2048


def _query_matrix_selfjoin(index: SketchIndex, out: GzTextWriter) -> bool:
    """The full all-vs-all sweep over blocks of B index rows. Block i+1 and
    i+2 are dispatched before block i is formatted, and each block's device
    to host copy runs on a fetch thread, so the card counts while the host
    formats. Byte-identical with the dense loop of ``query_matrix``."""
    sym = os.environ.get("NIQKI_TPU_MATRIX_SYM", "auto")
    if sym == "on":
        raise NotImplementedError("NIQKI_TPU_MATRIX_SYM=on: the symmetric "
                                  "sweep is not ported yet")
    p = index.params
    xp = index._planes()
    G, Gp = index.G, xp.shape[1]
    sparse = p.min_score > 0
    B = min(int(os.environ.get("NIQKI_TPU_MATRIX_BLOCK",
                               bcount.MATRIX_BLOCK)), Gp)
    cap = min(Gp, int(os.environ.get("NIQKI_TPU_MATRIX_CAP", "1024")))
    fmt = native.MatrixFormatter(index.names, p.F, p.min_score)
    pfmt = _ParallelMatrixFmt(index.names, p.F, p.min_score)

    starts = []
    for lo in range(0, G, B):
        start = max(0, min(lo, Gp - B))
        starts.append((lo, start, lo - start, min(B - (lo - start), G - lo)))

    def dispatch(i):
        lo, start, off, n = starts[i]
        if sparse:
            return bcount._self_join_topk(xp, start, p.min_score, B=B,
                                          cap=cap)
        return bcount._self_join_dense(xp, start, B=B)

    def fetch(res):
        if sparse:
            return res[0].cpu().numpy(), res[1].cpu().numpy()
        return res.cpu().numpy()

    stats = {"wait": 0.0, "emit": 0.0, "disp": 0.0}
    ahead = max(1, int(os.environ.get("NIQKI_TPU_MATRIX_AHEAD", "2")))
    try:
        with ThreadPoolExecutor(1) as fetcher:
            pending = [fetcher.submit(fetch, dispatch(i))
                       for i in range(min(ahead, len(starts)))]
            for i in range(len(starts)):
                t0 = time.time()
                res = pending.pop(0).result()
                stats["wait"] += time.time() - t0
                if i + ahead < len(starts):
                    t0 = time.time()
                    d = dispatch(i + ahead)
                    stats["disp"] += time.time() - t0
                    pending.append(fetcher.submit(fetch, d))
                t0 = time.time()
                _emit_selfjoin_block(index, out, fmt, res, sparse, xp,
                                     starts[i], cap, B=B, G=G, Gp=Gp,
                                     pfmt=pfmt)
                stats["emit"] += time.time() - t0
    finally:
        pfmt.close()
    if os.environ.get("NIQKI_TPU_MATRIX_STATS"):
        print(f"full sweep: blocks={len(starts)} "
              f"device-wait {stats['wait']:.1f}s "
              f"dispatch {stats['disp']:.1f}s emit {stats['emit']:.1f}s",
              file=sys.stderr, flush=True)
    return True


def _emit_selfjoin_block(index, out, fmt, res, sparse, xp, blk, cap, *,
                         B, G, Gp, pfmt=None):
    """Write one block's rows. A sparse row whose top-k is full (its least
    kept count still passes min_score) may have lost survivors: only the
    BLOCK_Q sub-blocks holding such rows are re-counted dense, and sparse
    runs and dense rows are written interleaved in row order."""
    p = index.params
    lo, start, off, n = blk
    if not sparse:
        c = res[off:off + n, :G]
        if pfmt is not None:
            pfmt.write_dense(out, c, lo)
        else:
            out.write(fmt.format_dense(c, lo))
        return
    vals, idx = res
    vals, idx = vals[off:off + n], idx[off:off + n]
    over = (vals[:, -1] >= p.min_score) if cap < Gp else np.zeros(n, bool)
    if not over.any():
        if pfmt is not None:
            pfmt.write_sparse(out, vals, idx, lo)
        else:
            out.write(fmt.format_sparse(vals, idx, lo))
        return
    over_rows = np.nonzero(over)[0]
    dense_rows: dict[int, np.ndarray] = {}
    for s in np.unique(over_rows // bcount.BLOCK_Q):
        want = lo + int(s) * bcount.BLOCK_Q
        sub = max(0, min(want, Gp - bcount.BLOCK_Q))
        d = bcount._self_join_dense(
            xp, sub, B=bcount.BLOCK_Q).cpu().numpy()[:, :G]
        for r in over_rows:
            if int(r) // bcount.BLOCK_Q == int(s):
                dense_rows[int(r)] = d[lo + int(r) - sub]
    r = 0
    while r < n:
        if over[r]:
            out.write(fmt.format_dense(dense_rows[r][None, :], lo + r))
            r += 1
        else:
            e = r
            while e < n and not over[e]:
                e += 1
            out.write(fmt.format_sparse(vals[r:e], idx[r:e], lo + r))
            r = e


def query_matrix(index: SketchIndex, out: GzTextWriter,
                 batch: int = 10000) -> None:
    """All-vs-all: the Jaccard matrix of the index against itself."""
    write_matrix_header(out, index.names)
    if index.G and _matrix_selfjoin_mode(index) \
            and _query_matrix_selfjoin(index, out):
        return
    p = index.params
    mat = index.matrix()
    for lo in range(0, index.G, batch):
        hi = min(lo + batch, index.G)
        # the reference's matrix counters are uint16 (a genome's
        # self-count of F wraps at lF >= 16)
        counts = index.counts(mat[lo:hi]) & 0xFFFF
        for r in range(hi - lo):
            write_matrix_row(out, index.names[lo + r], counts[r].tolist(),
                             p.F, p.min_score)


def query_file_matrix(index: SketchIndex, path: str,
                      out: GzTextWriter) -> None:
    """One matrix-formatted row (no header) for a whole-file query: the
    reference's query_file_whole_matrix."""
    counts = index.counts(index.sketch_file(path)[None, :])[0]
    write_matrix_row(out, path, counts.tolist(), index.params.F,
                     index.params.min_score)


def query_fof_matrix(index: SketchIndex, fof_path: str, out: GzTextWriter,
                     batch: int = 256) -> None:
    """Matrix-formatted rows for external query files (the reference's
    query_file_of_file_whole_matrix): entries resolve from the CWD with no
    length filter, as query fofs do."""
    write_matrix_header(out, index.names)
    entries = [ln for ln in read_query_fof(fof_path) if exists(ln)]
    for lo in range(0, len(entries), batch):
        chunk = entries[lo:lo + batch]
        counts = index.counts(np.stack(index.sketch_files(chunk)))
        for name, row in zip(chunk, counts):
            write_matrix_row(out, name, row.tolist(), index.params.F,
                             index.params.min_score)
