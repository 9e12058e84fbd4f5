"""SketchIndex on a torch device.

The port's counterpart of ``niqki_tpu/index.py``: the index is the dense
(G, F) int32 fingerprint matrix of the densified sketches on the host, with
device copies for counting (bit-planes for K2, pair-packed int16 for K3, the
plain matrix for the blocked count), each cached until the next insert.
Counts equal the reference's posting-list scans by construction: genome g
is in bucket (slot i, fingerprint v) iff sketches[g, i] == v.

The index's device is explicit: ``SketchIndex(params, device)`` runs on
``cuda`` unless the caller asks for ``cpu``, and raises when torch sees no
card. Lines mode (a record per entry) sketches records over
``HOST_SKETCH_MAX`` bases on the device and shorter ones on the host's
native sketcher; ``dump``/``load`` read and write the reference binary's
dump format (``dumpfmt``), and ``save_sharded``/``load_sharded`` the JAX
package's sharded checkpoints (v2 row blocks, v3 with bit-planes; v1 npz
is read). Under an active mesh (``NIQKI_TPU_MESH``, ``parallel.auto``)
the counts, the sparse hits and the sketch batches run on the mesh
(``parallel.serving.ShardedIndex``, ``ops.sketch``), and ``load_sharded``
with a mesh restarts mesh-direct.
"""

from __future__ import annotations

import json
import os
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import hostmem, native, oracle
from .debug import carry, dbg, span
from .dumpfmt import load_dump, save_dump
from .io.fasta import read_records
from .ops import bcount, mxucount, pcount
from .ops.count import match_counts_blocked
from .ops.sketch import INT32_MAX, dispatch_sketch_packed_batch, pack_codes
from .params import SketchParams
from .parallel.auto import active_mesh

# NIQKI_TPU_COUNT values the port routes
COUNT_MODES = ("auto", "host", "bcount", "pcount", "xla", "mxu")
CKPT_FORMATS = ("niqki_tpu.sharded.v1", "niqki_tpu.sharded.v2",
                "niqki_tpu.sharded.v3")


def _densify(sketch: np.ndarray, p: SketchParams) -> None:
    """In-place densification: native C++ when built, the oracle otherwise."""
    if native.available():
        native.densify(sketch)
    else:
        oracle.densify(sketch, p)


def _finalize_loop(hosts, rec_counts, p: SketchParams) -> list[np.ndarray]:
    """``native.finalize_files``' answer in numpy, a file at a time."""
    rows = {i: host[row] for chunk, host in hosts
            for row, i in enumerate(chunk)}
    out, k = [], 0
    for cnt in rec_counts:
        sketch = np.full(p.F, -1, dtype=np.int32)
        for i in range(k, k + cnt):
            table = rows.get(i)
            if table is None:
                continue
            if table.dtype == np.int16:  # narrow wire, -1 sentinel
                table = np.where(table == -1, INT32_MAX,
                                 table.astype(np.int32))
            cur = np.where(sketch == -1, INT32_MAX, sketch)
            merged = np.minimum(cur, table)
            sketch = np.where(merged == INT32_MAX, -1,
                              merged).astype(np.int32)
            _densify(sketch, p)
        out.append(sketch)
        k += cnt
    return out


def hits_from_counts(counts: np.ndarray, min_score: int
                     ) -> list[tuple[int, int]]:
    """Thresholded (count, gid) list sorted count desc then gid desc, the
    reference's query_sketch ordering."""
    c = np.asarray(counts)
    sel = np.nonzero(c >= min_score)[0]
    order = np.lexsort((-sel, -c[sel].astype(np.int64)))
    return [(int(c[g]), int(g)) for g in sel[order]]


def hits_from_counts_batch(counts: np.ndarray, min_score: int
                           ) -> list[list[tuple[int, int]]]:
    """hits_from_counts over a whole (B, G) block with one argsort (the
    per-row numpy calls dominate at read scale). The key -(count * G + gid)
    ascends in count-desc, gid-desc order; entries below the threshold key
    to +1, after every survivor, and the sorted columns are the gids."""
    c = np.asarray(counts)
    B, G = c.shape
    if G == 0:
        return [[] for _ in range(B)]
    keys = hostmem.big_empty((B, G), np.int64)
    keys[:] = c            # widen first: count * G overflows int32
    keys *= -G
    keys -= np.arange(G, dtype=np.int64)[None, :]
    keys[c < min_score] = 1
    order = np.argsort(keys, axis=1, kind="stable")
    nhits = (c >= min_score).sum(axis=1)
    return [[(int(c[b, g]), int(g)) for g in order[b, :nhits[b]]]
            for b in range(B)]


def _collect(dev: torch.Tensor) -> np.ndarray:
    """A batch of device sketch tables on the host (the copy waits for
    the batch's kernels)."""
    with span("k1.collect", 2) as sp:
        host = dev.cpu().numpy()
        if sp:
            sp.set(bytes=host.nbytes)
    return host


def _warn_unreadable(path: str, err: Exception) -> None:
    print(f"Warning: skipping unreadable file '{path}': {err}",
          file=sys.stderr)


class SketchIndex:
    # Lines-mode records pad to 256-base buckets, not the whole-genome
    # 2^14 floor (a 150 bp read in a 16 kb row wastes ~100x the work).
    LINES_MIN_PAD = 256
    # Lines-mode records of at most this many bases sketch on the host
    # (native rolling sketcher + densify on a thread pool), longer ones on
    # the device. NIQKI_TPU_HOST_READS overrides it (0: every record on the
    # device). The value is the JAX package's, set on its TPU.
    HOST_SKETCH_MAX = 32768
    # Per-chunk base budget of the lines-mode streams (64 Mbp, 16 MB
    # packed): the record bound alone would let chromosome-sized records
    # make a chunk arbitrarily large.
    CHUNK_BASES = 1 << 26

    def __init__(self, params: SketchParams, device="cuda",
                 backend: str = "torch"):
        self.params = params
        self.backend = backend
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SketchIndex on a CUDA device, but torch sees "
                               "no card (pass device='cpu' to run on the "
                               "CPU)")
        self.names: list[str] = []
        self._rows: list[np.ndarray] = []
        self._mat: np.ndarray | None = None  # consolidated (G, F)
        self._mat_loader = None              # lazy loader (mesh-direct)
        self._device_mat = None              # (G, F) for the blocked count
        self._device_packed = None           # pair-packed (Gp, F/2) for K3
        self._device_planes = None           # bit-planes for K2
        self._sharded = None                 # ShardedIndex on a mesh
        self._hits_fmt = None                # native HitsFormatter
        self._stored_host = None             # host count-side matrix

    # ------------------------------------------------------------------
    # state carried over from arrays or from the JAX package
    @classmethod
    def from_arrays(cls, params: SketchParams, names, mat: np.ndarray,
                    device="cuda") -> "SketchIndex":
        """An index holding ``names`` and the (G, F) int32 sketch matrix."""
        idx = cls(params, device=device)
        idx.names = list(names)
        idx._mat = np.ascontiguousarray(mat, np.int32)
        return idx

    @classmethod
    def from_jax(cls, jidx, device="cuda") -> "SketchIndex":
        """The same index as a ``niqki_tpu.SketchIndex`` (params field by
        field, the -G stale constants included; names; matrix)."""
        jp = jidx.params
        p = SketchParams(lF=jp.lF, K=jp.K, W=jp.W, H=jp.H,
                         min_fract=jp.min_fract,
                         stale_mask_M=jp.stale_mask_M,
                         stale_maximal_remainder=jp.stale_maximal_remainder)
        return cls.from_arrays(p, jidx.names, jidx.matrix(), device=device)

    # ------------------------------------------------------------------
    # sketching
    def sketch_records(self, seqs) -> np.ndarray:
        """Whole-file semantics: all records min-merge into one sketch
        (densified after each). Returns (F,) int32 with -1 empty."""
        p = self.params
        if self.backend == "numpy":
            return oracle.sketch_records(seqs, p)
        with span("index.encode", 2) as sp:
            recs = [pack_codes(*oracle.encode_record(s, p.K), p.K)
                    for s in seqs]
            if sp:
                sp.set(records=len(recs), bases=sum(r[1] for r in recs))
        batches = dispatch_sketch_packed_batch(recs, p, self.device)
        return self._collect_packed(batches, [len(recs)])[0]

    def _host_sketch_route(self) -> bool:
        """NIQKI_TPU_SKETCH=host sketches whole files and every lines-mode
        record on the host's native rolling sketcher instead of the device
        (the default)."""
        return (os.environ.get("NIQKI_TPU_SKETCH") == "host"
                and self.backend != "numpy" and native.available())

    def _host_sketch_whole(self, recs) -> np.ndarray:
        p = self.params
        return native.sketch_packed_whole(
            recs, p.lF, p.K, p.W, p.H, p.mask_M, p.maximal_remainder)

    def sketch_file(self, path: str) -> np.ndarray:
        """The whole-file sketch of one file: its ``sketch_files`` row,
        except that a file that cannot be read raises (OSError where it
        cannot be opened) instead of being skipped."""
        return self._sketch_files([path], 1, None, strict=True)[0]

    def _load_packed(self, paths, io_threads: int) -> list:
        """Each file's records packed into the 2-bit wire (words, n_bases,
        exc_idx), or the error the file gave: one native call for all the
        paths, which releases the GIL once (on ``io_threads`` native
        threads, at most one a file), or, where the library is absent, the
        Python reader file by file. Of a damaged gzip the native reader
        keeps what inflated, where Python's gzip raises."""
        p = self.params
        with span("index.read", 2) as sp:
            if native.available():
                files, threads = native.read_packed_files(paths, p.K,
                                                          io_threads)
            else:
                files, threads = [], 1
                for path in paths:
                    try:
                        files.append(
                            [pack_codes(*oracle.encode_record(s, p.K), p.K)
                             for _, s in read_records(path, p.K)])
                    except (OSError, EOFError, zlib.error) as e:
                        files.append(e)
            if sp:
                ok = [recs for recs in files if isinstance(recs, list)]
                sp.set(files=len(paths), records=sum(map(len, ok)),
                       bases=sum(r[1] for recs in ok for r in recs),
                       threads=threads, skipped=len(files) - len(ok))
        return files

    def _iter_packed_with_headers(self, path: str):
        """Yield (header, words, n_bases, exc_idx) per record of one file,
        streamed: nothing beyond the current chunk is held."""
        p = self.params
        if native.available():
            yield from native.read_packed_records_chunked(path, p.K)
            return
        for h, s in read_records(path, p.K):
            yield (h, *pack_codes(*oracle.encode_record(s, p.K), p.K))

    def _load_packed_with_headers(self, path: str):
        """(header, words, n_bases, exc_idx) per record of one file."""
        return list(self._iter_packed_with_headers(path))

    def sketch_packed_records(self, packed_records,
                              min_pad: int = 1 << 14) -> list[np.ndarray]:
        """One final sketch (-1 empty) per packed (words, n, exc) record,
        sketched on the device in batches of one shape each."""
        if not packed_records:
            return []
        batches = dispatch_sketch_packed_batch(packed_records, self.params,
                                               self.device, min_pad=min_pad)
        return self._collect_packed(batches, [1] * len(packed_records))

    def _collect_packed(self, batches, rec_counts) -> list[np.ndarray]:
        """One final sketch (-1 empty) a file from the device batches of
        its records, file i holding the next ``rec_counts[i]`` records:
        its tables min-merged in record order and densified after each
        (densified fillers of earlier records take part in later mins, as
        in the reference); a file without k-mers gets an empty sketch.
        One native call finalizes every file, on up to 8 threads across
        files; ``_finalize_loop`` where the library is absent."""
        if not rec_counts:
            return []
        hosts = [(chunk, _collect(dev)) for chunk, dev in batches]
        with span("index.finalize", 2) as sp:
            if native.available():
                out, threads = native.finalize_files(
                    hosts, rec_counts, self.params.F,
                    min(8, os.cpu_count() or 1))
            else:
                out, threads = _finalize_loop(hosts, rec_counts,
                                              self.params), 1
            if sp:
                present = np.zeros(sum(rec_counts) + 1, np.int64)
                for chunk, _ in hosts:
                    present[np.asarray(chunk, np.int64) + 1] = 1
                seen = np.cumsum(present)[np.cumsum([0, *rec_counts])]
                sp.set(files=len(rec_counts), records=sum(rec_counts),
                       merged=int((np.diff(seen) >= 2).sum()),
                       threads=threads)
        return out

    def _host_sketch_packed(self, recs) -> list[np.ndarray]:
        """Final sketches (-1 empty) of short packed records on the host's
        rolling sketcher plus densify, one native call for the group;
        bit-exact with the device route."""
        p = self.params
        with span("stream.host_sketch", 2) as sp:
            if sp:
                sp.set(records=len(recs))
            return list(native.sketch_packed_batch(
                recs, p.lF, p.K, p.W, p.H, p.mask_M, p.maximal_remainder))

    def _sketch_stream(self, rec_iter, chunk_records: int = 1 << 15):
        """Yield (records_chunk, sketches) pairs from a packed-record
        stream with one chunk of read-ahead: chunk i+1 is read and its
        device work queued before chunk i is collected, so peak memory is
        two chunks, never the whole file. Chunks are bounded by records and
        by bases (CHUNK_BASES).

        Records over HOST_SKETCH_MAX bases (NIQKI_TPU_HOST_READS) sketch on
        the device (K1); shorter ones on the host sketcher on a thread
        pool, whose threads touch no tensor. A chunk of short records only
        never touches the device. NIQKI_TPU_SKETCH=host sketches every
        record on the host."""
        host_max = int(os.environ.get("NIQKI_TPU_HOST_READS",
                                      self.HOST_SKETCH_MAX))
        if self._host_sketch_route():
            host_max = 1 << 62
        use_host = native.available()
        pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
        pending = None

        def take_chunk():
            part, bases = [], 0
            with span("stream.read", 2) as sp:
                for rec in rec_iter:
                    part.append(rec)
                    bases += rec[2]
                    if len(part) >= chunk_records or \
                            bases >= self.CHUNK_BASES:
                        break
                if sp:
                    sp.set(records=len(part), bases=bases)
            return part

        try:
            while True:
                part = take_chunk()
                host_task = carry(self._host_sketch_packed)
                work = None
                if part:
                    recs = [r[1:] for r in part]
                    short, long = [], []
                    for i, r in enumerate(recs):
                        (short if use_host and r[1] <= host_max
                         else long).append(i)
                    batches = dispatch_sketch_packed_batch(
                        [recs[i] for i in long], self.params, self.device,
                        min_pad=self.LINES_MIN_PAD) if long else []
                    grp = max(64, -(-len(short) // 32))
                    futs = [(short[lo:lo + grp], pool.submit(
                        host_task, [recs[i] for i in short[lo:lo + grp]]))
                        for lo in range(0, len(short), grp)]
                    work = (part, long, batches, futs)
                if pending is not None:
                    ppart, plong, pbatches, pfuts = pending
                    sks = [None] * len(ppart)
                    for i, sk in zip(plong, self._collect_packed(
                            pbatches, [1] * len(plong))):
                        sks[i] = sk
                    with span("stream.wait", 2) as sp:
                        if sp:
                            sp.set(tasks=len(pfuts))
                        for idxs, fut in pfuts:
                            for i, sk in zip(idxs, fut.result()):
                                sks[i] = sk
                    yield ppart, sks
                if not part:
                    return
                pending = work
        finally:
            pool.shutdown(wait=False)

    def insert_file_lines(self, path: str,
                          chunk_records: int = 1 << 15) -> list[int]:
        """Each record of the file becomes an entry named by its header
        line (with its '>'/'@'), streamed in chunks of ``chunk_records``
        records with bounded memory."""
        if self.backend == "numpy":
            return [self.insert_sketch(self.sketch_records([s]), h)
                    for h, s in read_records(path, self.params.K)]
        gids = []
        for part, sks in self._sketch_stream(
                self._iter_packed_with_headers(path), chunk_records):
            with span("index.insert_rows", 2) as sp:
                if sp:
                    sp.set(rows=len(part))
                gids.extend(self.insert_sketch(sk, r[0])
                            for r, sk in zip(part, sks))
        return gids

    def sketch_files(self, paths, window: int = 256,
                     io_threads: int | None = None) -> list[np.ndarray]:
        """Whole-file sketches for many files, read a window of ``window``
        files (NIQKI_TPU_WINDOW overrides it) at a time in one
        ``_load_packed`` call. The device route sketches all of a window's
        records in batches (a window of 100 kb records stacks into batches
        of up to 256 rows of 2^17 bases) and collects the previous window's
        tables while the next one is read; NIQKI_TPU_SKETCH=host sketches
        each file on the host sketcher, a pool task a file, and the numpy
        backend on the oracle. An unreadable file is skipped with a
        warning and an empty sketch, as the reference skips missing
        entries."""
        return self._sketch_files(list(paths), window, io_threads,
                                  strict=False)

    def _sketch_files(self, paths, window: int, io_threads, strict: bool
                      ) -> list:
        p = self.params
        with span("index.sketch_files") as sp:
            if self.backend == "numpy":     # the oracle sketches strings
                if sp:
                    sp.set(files=len(paths), batched=0)
                return [self.sketch_records(
                    s for _, s in read_records(pa, p.K)) for pa in paths]
            if sp:
                sp.set(files=len(paths),
                       batched=len(paths) if native.available() else 0)
            env_w = os.environ.get("NIQKI_TPU_WINDOW")
            if env_w:
                window = max(1, int(env_w))
            io_threads = io_threads or min(8, os.cpu_count() or 1)
            windows = self._read_windows(paths, window, io_threads, strict)
            if self._host_sketch_route():
                sketch = carry(self._host_sketch_whole)
                with ThreadPoolExecutor(max_workers=io_threads) as pool:
                    return [sk for files in windows
                            for sk in pool.map(sketch, files)]
            out: list = []
            pending = None
            n_records = 0
            for w0, files in zip(range(0, len(paths), window), windows):
                records = [rec for recs in files for rec in recs]
                n_records += len(records)
                batches = dispatch_sketch_packed_batch(records, p,
                                                       self.device)
                dbg(f"window @{w0}: {len(files)} files, {len(records)} "
                    f"records, {len(batches)} device batches")
                if pending is not None:
                    out += self._collect_packed(*pending)
                pending = (batches, [len(recs) for recs in files])
            if pending is not None:
                out += self._collect_packed(*pending)
            if sp:
                sp.set(records=n_records)
            return out

    def _read_windows(self, paths, window: int, io_threads: int,
                      strict: bool):
        """Yield each window's files' records, read when the window is
        taken; a file that cannot be read raises under ``strict`` and is
        otherwise skipped with a warning (no records)."""
        for w0 in range(0, len(paths), window):
            part = paths[w0:w0 + window]
            files = self._load_packed(part, io_threads)
            for i, recs in enumerate(files):
                if not isinstance(recs, list):
                    if strict:
                        raise recs
                    _warn_unreadable(part[i], recs)
                    files[i] = []
            yield files

    # ------------------------------------------------------------------
    # insertion and the dense matrix
    def insert_sketch(self, sketch: np.ndarray, name: str) -> int:
        gid = len(self.names)
        self.names.append(name)
        self._rows.append(np.asarray(sketch, np.int32))
        self._device_mat = None
        self._device_packed = None
        self._device_planes = None
        self._stored_host = None
        return gid

    def insert_file_whole(self, path: str, name: str | None = None) -> int:
        """Insert one file as one genome (its records min-merged); the name
        defaults to the path."""
        return self.insert_sketch(self.sketch_file(path), name or path)

    @property
    def G(self) -> int:
        return len(self.names)

    def matrix(self) -> np.ndarray:
        if self._mat is None and self._mat_loader is not None:
            # a mesh-direct load keeps the host matrix lazy: serving needs
            # only the shards' planes
            self._mat, self._mat_loader = self._mat_loader(), None
        if self._mat is None or len(self._mat) != self.G:
            if self._rows:
                prev = self._mat
                n_prev = len(prev) if prev is not None else 0
                with span("index.matrix") as sp:
                    mat = hostmem.big_empty(
                        (n_prev + len(self._rows), self.params.F), np.int32)
                    if n_prev:
                        mat[:n_prev] = prev
                    for i, r in enumerate(self._rows):
                        mat[n_prev + i] = r
                    if sp:
                        sp.set(rows=len(self._rows), bytes=mat.nbytes)
                self._mat = mat
                self._rows = []
            elif self._mat is None:
                self._mat = np.zeros((0, self.params.F), np.int32)
        return self._mat

    @property
    def _device_dtype(self):
        # W <= 14 fingerprints and the -1/-2/-3 sentinels fit int16
        return np.int16 if self.params.W <= 14 else np.int32

    def _stored(self) -> np.ndarray:
        """Count-side copy of the matrix: fingerprints outside [0, 2^W)
        become -2, as the reference's insert puts them in no bucket (empty
        slots, and the out-of-range values the -G stale constants can
        produce)."""
        mat = self.matrix()
        with span("index.stored") as sp:
            if sp:
                sp.set(bytes=mat.nbytes)
            out = hostmem.big_empty(mat.shape, np.int32)
            hi_fp = self.params.fingerprint_range
            B = 1 << 14

            def fix(lo):
                blk = mat[lo:lo + B]
                dst = out[lo:lo + B]
                np.copyto(dst, blk)
                dst[(blk < 0) | (blk >= hi_fp)] = -2

            blocks = range(0, len(mat), B)
            if len(mat) > B:  # numpy releases the GIL on the copies/compares
                with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as ex:
                    list(ex.map(fix, blocks))
            else:
                for lo in blocks:
                    fix(lo)
        return out

    def _stored_cached(self) -> np.ndarray:
        """_stored() cached until the next insert (the host count route
        runs once per query chunk)."""
        if self._stored_host is None or len(self._stored_host) != self.G:
            self._stored_host = self._stored()
        return self._stored_host

    def _query_side(self, q: np.ndarray) -> np.ndarray:
        """Out-of-range query fingerprints scan no bucket in the reference,
        so they map to -3: matching neither valid fingerprints nor the
        stored -2."""
        bad = (q < 0) | (q >= self.params.fingerprint_range)
        return np.where(bad, -3, q)

    # ------------------------------------------------------------------
    # device copies of the index
    def _device_matrix(self) -> torch.Tensor:
        if self._device_mat is None:
            self._device_mat = torch.from_numpy(
                self._stored().astype(self._device_dtype)).to(self.device)
        return self._device_mat

    def _planes(self) -> torch.Tensor:
        """The (W+1, Gp, F/32) index bit-planes on the device."""
        if self._device_planes is None:
            self._device_planes = bcount.build_index_planes(
                self._stored(), self.params.W, self.device, sanitized=True)
        return self._device_planes

    def _packed(self) -> torch.Tensor:
        """The (Gp, F/2) pair-packed int16 index on the device, rows padded
        to a TILE_G multiple with -2. Needs W <= 14: the sanitized values
        lie in [-2, 2^W), so the int16 cast is lossless."""
        if self._device_packed is None:
            mat16 = hostmem.pad_rows(
                hostmem.big_copy(self._stored(), np.int16), pcount.TILE_G)
            self._device_packed = pcount.pack_rows(
                torch.from_numpy(mat16)).to(self.device)
        return self._device_packed

    # ------------------------------------------------------------------
    # querying
    def _sharded_for(self, mesh):
        """The ShardedIndex serving this index on ``mesh``, rebuilt when G
        or the mesh changes (flipping NIQKI_TPU_MESH between calls must not
        reuse a stale layout; active_mesh hands out one object per spec)."""
        if self._sharded is None or self._sharded.G != self.G \
                or self._sharded.mesh is not mesh:
            from .parallel.serving import ShardedIndex
            self._sharded = ShardedIndex(self, mesh)
        return self._sharded

    def counts(self, q_sketches: np.ndarray) -> np.ndarray:
        """Hit counts (Q, G) for a batch of query sketches (Q, F).

        Under an active mesh the mesh's ShardedIndex counts, before any
        other route. Otherwise the routes are the JAX package's
        (NIQKI_TPU_COUNT = auto|host|bcount|pcount|xla|mxu): the native host
        count for G <= NIQKI_TPU_HOST_COUNT_G
        (default 2048) under auto; the bit-plane kernel K2 for G >= 4096
        (or when asked) under its shape gate; the pair-packed kernel K3 for
        G >= 4096, W <= 14 and its shape gate (the S <= 11 indexes);
        otherwise a plain torch blocked count, which ``xla`` forces; ``mxu``
        takes the one-hot matrix product (ops/mxucount, never a default).
        Any other mode raises."""
        raw = np.atleast_2d(np.asarray(q_sketches, np.int32))
        if self.G == 0:
            return np.zeros((len(raw), 0), np.int32)
        if self.backend == "numpy":
            q = self._query_side(raw)
            mat = self._stored()
            out = np.empty((len(q), self.G), np.int32)
            for i, row in enumerate(q):
                out[i] = (mat == row[None, :]).sum(axis=1, dtype=np.int32)
            return out
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
        if mode not in COUNT_MODES:
            raise ValueError(f"NIQKI_TPU_COUNT={mode}: not one of "
                             f"{', '.join(COUNT_MODES)}")
        mesh = active_mesh(self.device)
        if mesh is not None:
            return self._sharded_for(mesh).counts(self._query_side(raw))
        host_max_g = int(os.environ.get("NIQKI_TPU_HOST_COUNT_G", "2048"))
        if native.available() and (
                mode == "host" or (mode == "auto" and self.G <= host_max_g)):
            # raw q: the C++ count applies the query range guard itself
            return native.count_eq(np.ascontiguousarray(raw),
                                   self._stored_cached(),
                                   self.params.fingerprint_range)
        p = self.params
        q = self._query_side(raw)
        if mode == "mxu":
            return mxucount.match_counts_mxu(q, self._stored_cached(), p.W,
                                             self.device)
        want_b = mode == "bcount" or (
            mode == "auto" and self.G >= 4096)
        if want_b and bcount.available(p.F, p.W):
            return bcount.match_counts_planes(q, self._planes(), self.G, p.W,
                                              sanitized=True)
        if mode in ("auto", "pcount") and self.G >= 4096 and p.W <= 14 \
                and pcount.available(p.F):
            return pcount.match_counts_packed(q.astype(np.int16),
                                              self._packed(), self.G)
        return self._counts_blocked(q)

    def _counts_blocked(self, q: np.ndarray) -> np.ndarray:
        """Plain torch equality count against the device matrix
        (``ops.count.match_counts_blocked``; the route for indexes outside
        both kernels' gates, and NIQKI_TPU_COUNT=xla), in blocks of at most
        2^26 compared elements."""
        block = max(1, (1 << 26) // (self.G * self.params.F))
        qd = torch.from_numpy(q.astype(self._device_dtype)).to(self.device)
        return match_counts_blocked(qd, self._device_matrix(),
                                    block_q=block).cpu().numpy()

    def query_sketch_stream(self, rec_iter, chunk_records: int = 1 << 15):
        """Yield (records_chunk, stacked (n, F) int32 sketches) pairs from
        a packed-record stream, with bounded memory."""
        for part, sks in self._sketch_stream(rec_iter, chunk_records):
            q = hostmem.big_empty((len(sks), self.params.F), np.int32)
            for i, s in enumerate(sks):
                q[i] = s
            yield part, q

    def query_counts_stream(self, rec_iter, chunk_records: int = 1 << 15):
        """Yield (records_chunk, (n, G) counts) pairs from a packed-record
        stream, one count call per chunk."""
        for part, q in self.query_sketch_stream(rec_iter, chunk_records):
            yield part, (self.counts(q) if len(q)
                         else np.zeros((0, self.G), np.int32))

    def hits_from_counts(self, c: np.ndarray) -> list[tuple[int, int]]:
        return hits_from_counts(c, self.params.min_score)

    def hits(self, q_sketch: np.ndarray) -> list[tuple[int, int]]:
        """(count, gid) hits of one query sketch, count-descending."""
        return self.hits_from_counts(self.counts(q_sketch[None, :])[0])

    def all_vs_all_counts(self) -> np.ndarray:
        """(G, G) count matrix of the index against itself."""
        return self.counts(self.matrix())

    def _hits_fmt_cached(self):
        if self._hits_fmt is None or self._hits_fmt.G != self.G:
            self._hits_fmt = native.HitsFormatter(self.names, self.params.F,
                                                  self.params.min_score)
        return self._hits_fmt

    def _emit_sparse_rows(self, q, headers, vals, idx, over,
                          dense_fn) -> bytes:
        """Format the top-k (vals, idx) survivors, re-fetching rows whose
        survivors overflowed the cap through ``dense_fn(rows)``:
        byte-identical with HitsFormatter.format(counts(q), headers)."""
        fmt = self._hits_fmt_cached()
        if not over.any():
            return fmt.format_sparse(vals, idx, headers)
        if over.mean() > 0.25:
            # hit-saturated batch: one dense pass costs less than per-row
            # re-fetches
            with span("k2.refetch", 2) as sp:
                if sp:
                    sp.set(rows=len(q))
                dense = dense_fn(q)
            return fmt.format(dense, headers)
        dense_rows = np.nonzero(over)[0]
        with span("k2.refetch", 2) as sp:
            if sp:
                sp.set(rows=len(dense_rows))
            dense = dense_fn(q[dense_rows])
        parts, di = [], 0
        for r in range(len(q)):
            if over[r]:
                parts.append(fmt.format(dense[di:di + 1], [headers[r]]))
                di += 1
            else:
                parts.append(fmt.format_sparse(vals[r:r + 1], idx[r:r + 1],
                                               [headers[r]]))
        return b"".join(parts)

    def pretty_hits_batch(self, q_sketches: np.ndarray,
                          headers: list[str]) -> bytes | None:
        """Formatted pretty-hit rows through the sparse device path: per
        BLOCK_Q block, query pack + K2 count + top-k, so only surviving
        (count, gid) pairs come back. Byte-identical with
        HitsFormatter.format(counts(q), headers): rows whose survivors
        overflow the cap (NIQKI_TPU_HITS_CAP, default 2048) are re-fetched
        dense. Under an active mesh the same contract is served by
        per-shard top-k with global gids (ShardedIndex.topk_counts), ahead
        of the G >= 4096 gate: a row overflows where any shard's last kept
        count passes min_score. Returns None when not eligible (callers use
        dense counts)."""
        p = self.params
        if (self.backend == "numpy" or not native.available()
                or p.min_score < 1 or not bcount.available(p.F, p.W)):
            return None
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
        if mode not in ("auto", "bcount"):
            return None
        cap = min(self.G, int(os.environ.get("NIQKI_TPU_HITS_CAP", "2048")))
        if cap < 1:
            return None
        raw = np.atleast_2d(np.asarray(q_sketches, np.int32))
        if len(raw) != len(headers):
            raise ValueError(f"{len(raw)} query sketches, {len(headers)} "
                             "headers")
        mesh = active_mesh(self.device)
        if mesh is not None:
            sharded = self._sharded_for(mesh)
            q = self._query_side(raw)
            res = sharded.topk_counts(q, cap, p.min_score)
            if res is None:     # not the planes route: dense counts serve
                return None
            vals, gids, shard_cap = res
            tp = vals.shape[1] // shard_cap
            if shard_cap < sharded._Gp // tp:
                over = (vals.reshape(len(q), tp, shard_cap)[:, :, -1]
                        >= p.min_score).any(axis=1)
            else:
                over = np.zeros(len(q), bool)
            return self._emit_sparse_rows(q, headers, vals, gids, over,
                                          sharded.counts)
        if self.G < 4096:
            return None
        q = self._query_side(raw)
        xp = self._planes()
        vals, idx = bcount.match_counts_planes(
            q, xp, self.G, p.W, sanitized=True, topk=cap,
            min_score=p.min_score)
        over = (vals[:, -1] >= p.min_score) if cap < self.G else \
            np.zeros(len(vals), bool)

        def dense_fn(qq):
            return bcount.match_counts_planes(qq, xp, self.G, p.W,
                                              sanitized=True)

        return self._emit_sparse_rows(q, headers, vals, idx, over, dense_fn)

    # ------------------------------------------------------------------
    # the reference binary's dump format (-D / -L)
    def dump(self, path: str) -> None:
        save_dump(path, self.params, self.matrix(), self.names)

    @classmethod
    def load(cls, path: str, device="cuda",
             backend: str = "torch") -> "SketchIndex":
        """The index of a dump, on ``device``: its params come from the
        dump's header (min_score included), its matrix and names from the
        dump."""
        hdr, mat, names = load_dump(path)
        idx = cls(hdr.params(), device=device, backend=backend)
        idx._mat = mat
        idx.names = list(names)
        return idx

    # ------------------------------------------------------------------
    # the sharded checkpoint (the JAX package's format: raw row blocks per
    # genome range, v3 adding the bit-planes; v1 was npz)
    def save_sharded(self, directory: str, num_shards: int = 1,
                     compress: bool = True, planes: bool = False) -> None:
        """Write the sharded checkpoint the JAX package writes, file for
        file: per shard a block of little-endian int32 rows
        (``shard_%05d.bin``, or ``.bin.gz``: one-shot zlib level 1 in a
        gzip container), its names newline-joined in UTF-8
        (``shard_%05d.names``) and, with ``planes`` (format v3), its
        (W+1, rows, F/32) uint32 bit-planes from the native pack
        (``planes_%05d.bin``); then ``manifest.json``. Raw blocks and
        planes are written with O_DIRECT; shards are written in parallel."""
        os.makedirs(directory, exist_ok=True)
        mat = np.ascontiguousarray(self.matrix(), np.int32)
        bounds = np.linspace(0, self.G, num_shards + 1).astype(int)
        p = self.params
        manifest = {
            "format": CKPT_FORMATS[2] if planes else CKPT_FORMATS[1],
            "params": {"lF": p.lF, "K": p.K, "W": p.W, "H": p.H,
                       "min_fract": p.min_fract,
                       # the -G stale fingerprint constants (None: derived
                       # from H), so a reloaded -G index sketches queries
                       # with its rows' constants
                       "stale_mask_M": p.stale_mask_M,
                       "stale_maximal_remainder": p.stale_maximal_remainder},
            "genomes": self.G,
            "compress": bool(compress),
            "shards": [],
        }

        def write_shard(s: int) -> dict:
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            fn = f"shard_{s:05d}.bin" + (".gz" if compress else "")
            if compress:
                co = zlib.compressobj(1, zlib.DEFLATED, 31)
                with open(os.path.join(directory, fn), "wb") as f:
                    f.write(co.compress(memoryview(mat[lo:hi])))
                    f.write(co.flush())
            else:
                hostmem.write_direct(os.path.join(directory, fn), mat[lo:hi])
            nf = f"shard_{s:05d}.names"
            with open(os.path.join(directory, nf), "wb") as f:
                f.write("\n".join(self.names[lo:hi]).encode())
            entry = {"file": fn, "names": nf, "lo": lo, "hi": hi}
            if planes:
                pf = f"planes_{s:05d}.bin"
                hostmem.write_direct(os.path.join(directory, pf),
                                     bcount.np_pack_bitplanes(mat[lo:hi], p.W))
                entry["planes"] = pf
            return entry

        if num_shards == 1:
            manifest["shards"].append(write_shard(0))
        else:
            with ThreadPoolExecutor(min(num_shards,
                                        max(2, os.cpu_count() or 2))) as ex:
                manifest["shards"].extend(ex.map(write_shard,
                                                 range(num_shards)))
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load_sharded(cls, directory: str, device="cuda",
                     backend: str = "torch", mesh=None) -> "SketchIndex":
        """The index of a sharded checkpoint (v1, v2 or v3; another format
        raises), on ``device``: params from the manifest (the -G stale
        constants included), the host matrix and names from the shards,
        read in parallel. No device copy is built here: the first count
        builds planes or pairs on the card from the matrix.

        With ``mesh`` the serving path restarts mesh-direct: each 'tp'
        shard's planes go straight to its devices
        (ShardedIndex.from_checkpoint, no global host matrix), the index
        is on this rank's first mesh device, and its host matrix stays
        lazy (read only if matrix() or dump() is called)."""
        if mesh is not None:
            from .parallel.serving import ShardedIndex
            sharded = ShardedIndex.from_checkpoint(directory, mesh)
            idx = cls(sharded.params, device=mesh.first_local,
                      backend=backend)
            idx.names = list(sharded.names)
            idx._sharded = sharded
            idx._mat_loader = lambda: cls.load_sharded(
                directory, device=mesh.first_local,
                backend=backend).matrix()
            return idx
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt not in CKPT_FORMATS:
            raise ValueError(f"unknown checkpoint format {fmt!r} in "
                             f"{directory}")
        pp = manifest["params"]
        idx = cls(SketchParams(
            lF=pp["lF"], K=pp["K"], W=pp["W"], H=pp["H"],
            min_fract=pp["min_fract"],
            stale_mask_M=pp.get("stale_mask_M"),
            stale_maximal_remainder=pp.get("stale_maximal_remainder")),
            device=device, backend=backend)
        F = idx.params.F
        mat = hostmem.big_empty((manifest["genomes"], F), np.int32)
        shards = manifest["shards"]
        shard_names: list[list[str]] = [[] for _ in shards]

        def read_shard(s: int) -> None:
            sh = shards[s]
            path = os.path.join(directory, sh["file"])
            lo, hi = sh["lo"], sh["hi"]
            if fmt == CKPT_FORMATS[0]:       # npz of sketches and names
                with np.load(path, allow_pickle=True) as z:
                    mat[lo:hi] = z["sketches"]
                    shard_names[s] = z["names"].tolist()
                return
            if sh["file"].endswith(".gz"):
                with open(path, "rb") as f:
                    raw = zlib.decompress(f.read(), 31)
                mat[lo:hi] = np.frombuffer(raw, np.int32).reshape(hi - lo, F)
            else:
                hostmem.read_direct(path, mat[lo:hi])
            with open(os.path.join(directory, sh["names"]), "rb") as f:
                blob = f.read().decode()
            shard_names[s] = blob.split("\n") if hi > lo else []

        if len(shards) <= 1:
            for s in range(len(shards)):
                read_shard(s)
        else:
            with ThreadPoolExecutor(min(len(shards),
                                        max(2, os.cpu_count() or 2))) as ex:
                list(ex.map(read_shard, range(len(shards))))
        idx._mat = mat
        idx.names = [n for ns in shard_names for n in ns]
        return idx
