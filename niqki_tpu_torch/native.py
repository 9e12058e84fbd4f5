"""ctypes bindings of the port's native host library
(``csrc/host.cpp``: every export of ``csrc/niqki_host.cpp``, the port's
own copy of its host runtime, and the window reader).

The port's counterpart of ``niqki_tpu/native.py``: the FASTA/FASTQ reader
(encoded or packed, per record and chunked; packed, a window of whole
files in one call), densify, the host sketchers
(the rolling sketch of code arrays, whole-file and per-record batches of
packed records, and their per-stage timer), the dump's bucket-stream
scanners, the host equality count, the matrix and hit formatters, the
bit-plane pack of checkpoints and the gzip member deflate of the writer.
The library is built at first use into ``build/niqki_tpu_torch/``, named
after its sources' hash (``make -C niqki_tpu_torch/csrc OUT=...``;
NIQKI_TPU_NO_NATIVE_BUILD=1 skips the build, and NIQKI_TPU_NO_NATIVE=1
leaves the library unloaded); the JAX package's ``native/libniqki_host.so``
is not used. The Makefile probes
for libdeflate with ``printf '\\#include <libdeflate.h>'``, which keeps the
backslash under GNU make 4.3+ and so passes where libdeflate is absent;
when that build leaves no library, it is built once more with
``HAVE_DEFLATE=0`` (zlib only, the same decompressed bytes). Where no
library is loaded, callers take the pure-Python paths. The answer is
cached at the first call (``_tried``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

from . import hostmem
from .debug import span

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_REPO_ROOT, "niqki_tpu_torch", "csrc")
_SOURCES = tuple(os.path.join(_CSRC_DIR, name)
                 for name in ("Makefile", "host.cpp", "niqki_host.cpp"))
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "niqki_tpu_torch")
_ABI_VERSION = 11

_ALLOC = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64)

_lib = None
_tried = False
_lock = threading.Lock()


def _so_path() -> str:
    h = hashlib.sha256()
    for path in _SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libniqki_host_{h.hexdigest()[:16]}.so")


def _build() -> str:
    """The library's path, built there first unless it exists or
    NIQKI_TPU_NO_NATIVE_BUILD is set."""
    so = _so_path()
    if os.environ.get("NIQKI_TPU_NO_NATIVE_BUILD"):
        return so
    for extra in ([], ["HAVE_DEFLATE=0"]):
        if os.path.exists(so):
            break
        try:
            subprocess.run(["make", "-C", _CSRC_DIR, "-s", f"OUT={so}",
                            *extra],
                           capture_output=True, timeout=300, check=False)
        except (OSError, subprocess.TimeoutExpired):
            break           # no make: the pure-Python host paths serve
    return so


def _bind(lib) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    arr = np.ctypeslib.ndpointer
    i32c = arr(np.int32, flags="C_CONTIGUOUS")
    i64c = arr(np.int64, flags="C_CONTIGUOUS")
    u32c = arr(np.uint32, flags="C_CONTIGUOUS")
    lib.nq_abi_version.restype = i64
    lib.nq_abi_version.argtypes = []
    lib.nq_reader_open.restype = vp
    lib.nq_reader_open.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
    lib.nq_reader_close.restype = None
    lib.nq_reader_close.argtypes = [vp]
    u8c = arr(np.uint8, flags="C_CONTIGUOUS")
    lib.nq_reader_next.restype = ctypes.c_int
    lib.nq_reader_next.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64),
        ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(i64)]
    lib.nq_sketch_codes.restype = None
    lib.nq_sketch_codes.argtypes = [u8c, u8c] + [i64] * 7 + [i32c]
    lib.nq_scan_dump_sizes.restype = i64
    lib.nq_scan_dump_sizes.argtypes = [u32c, i64, i64, u32c]
    lib.nq_gzip_bound.restype = i64
    lib.nq_gzip_bound.argtypes = [i64, i64]
    lib.nq_gzip_member.restype = i64
    lib.nq_gzip_member.argtypes = [vp, i64, i64, vp, i64]
    lib.nq_sketch_stage_bench.restype = i64
    lib.nq_sketch_stage_bench.argtypes = [u32c] + [i64] * 8 + [
        arr(np.float64, flags="C_CONTIGUOUS")]
    lib.nq_reader_next_packed.restype = ctypes.c_int
    lib.nq_reader_next_packed.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64),
        ctypes.POINTER(vp), ctypes.POINTER(i64), ctypes.POINTER(vp),
        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.nq_densify.restype = None
    lib.nq_densify.argtypes = [i32c, i64]
    lib.nq_reader_next_chunk.restype = i64
    lib.nq_reader_next_chunk.argtypes = [
        vp, i64, i64, ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(vp)]
    lib.nq_sketch_packed_whole.restype = None
    lib.nq_sketch_packed_whole.argtypes = [u32c, i64c, i64c, i32c, i64c] \
        + [i64] * 7 + [i32c]
    lib.nq_sketch_packed_batch.restype = None
    lib.nq_sketch_packed_batch.argtypes = [u32c, i64c, i64c, i32c, i64c] \
        + [i64] * 7 + [i32c]
    lib.nq_scan_dump_stream.restype = i64
    lib.nq_scan_dump_stream.argtypes = [
        u32c, i64, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(i64), u32c, i64c]
    lib.nq_count_eq.restype = None
    lib.nq_count_eq.argtypes = [i32c, i64, i32c, i64, i64, i64, i32c]
    lib.nq_format_hits.restype = i64
    lib.nq_format_hits.argtypes = [
        i32c, i64, i64, i64, i64, ctypes.c_char_p, i64c, ctypes.c_char_p,
        i64c, ctypes.c_char_p, i64]
    lib.nq_format_hits_sparse.restype = i64
    lib.nq_format_hits_sparse.argtypes = [
        i32c, i32c, i64, i64, i64, i64, i64, ctypes.c_char_p, i64c,
        ctypes.c_char_p, i64c, ctypes.c_char_p, i64]
    lib.nq_format_matrix_sparse.restype = i64
    lib.nq_format_matrix_sparse.argtypes = [
        i32c, i32c, i64, i64, i64, i64, i64, ctypes.c_char_p, i64c, i64,
        ctypes.c_char_p, i64]
    lib.nq_format_matrix_dense.restype = i64
    lib.nq_format_matrix_dense.argtypes = [
        arr(np.uint16, flags="C_CONTIGUOUS"), i64, i64, i64, i64,
        ctypes.c_char_p, i64c, i64, ctypes.c_char_p, i64]
    lib.nq_pack_bitplanes.restype = i64
    lib.nq_pack_bitplanes.argtypes = [i32c, i64, i64, i64, vp, i64]
    lib.nq_read_packed_files.restype = i64
    lib.nq_read_packed_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64, i64, i64, _ALLOC, i64c, i32c]


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("NIQKI_TPU_NO_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(_build())
        except OSError:     # absent, or built for another machine
            return None
        _bind(lib)
        if lib.nq_abi_version() != _ABI_VERSION:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is loaded (built at the first call)."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def read_encoded_records(path: str, K: int, ftype: str | None = None
                         ) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Yield (header, eff_fwd, eff_rc) uint8 code arrays per record of
    length > K: the records of ``io.fasta.read_records`` encoded as
    ``oracle.encode_record`` does, with gzip decode, parse and encode in
    C++."""
    lib = _require()
    ft = {None: 0, "A": 1, "Q": 2}[ftype]
    h = lib.nq_reader_open(path.encode(), K, ft)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        hdr = ctypes.c_char_p()
        hlen, slen = ctypes.c_int64(), ctypes.c_int64()
        pf, pr = ctypes.c_void_p(), ctypes.c_void_p()
        while lib.nq_reader_next(h, ctypes.byref(hdr), ctypes.byref(hlen),
                                 ctypes.byref(pf), ctypes.byref(pr),
                                 ctypes.byref(slen)) == 1:
            n = slen.value
            header = ctypes.string_at(hdr, hlen.value).decode(
                "utf-8", "replace")
            yield (header, _as_np(pf, n, ctypes.c_uint8, np.uint8),
                   _as_np(pr, n, ctypes.c_uint8, np.uint8))
    finally:
        lib.nq_reader_close(h)


def read_packed_records(path: str, K: int, ftype: str | None = None
                        ) -> Iterator[Tuple[str, np.ndarray, int, np.ndarray]]:
    """Yield (header, packed_words, n_bases, exc_idx) per record (len > K).

    packed_words: uint32, base i's forward code in bits 2*(i%16) of word
    i//16. exc_idx: int32 positions (>= K-1) where the true reverse-
    complement code is 0 instead of the derived 3 - fwd (non-ACGT)."""
    lib = _require()
    ft = {None: 0, "A": 1, "Q": 2}[ftype]
    h = lib.nq_reader_open(path.encode(), K, ft)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        hdr = ctypes.c_char_p()
        hlen, nw, ne, slen = (ctypes.c_int64() for _ in range(4))
        pw, pe = ctypes.c_void_p(), ctypes.c_void_p()
        while lib.nq_reader_next_packed(
                h, ctypes.byref(hdr), ctypes.byref(hlen), ctypes.byref(pw),
                ctypes.byref(nw), ctypes.byref(pe), ctypes.byref(ne),
                ctypes.byref(slen)) == 1:
            words = np.ctypeslib.as_array(
                ctypes.cast(pw, ctypes.POINTER(ctypes.c_uint32)),
                (nw.value,)).copy()
            if ne.value:
                exc = np.ctypeslib.as_array(
                    ctypes.cast(pe, ctypes.POINTER(ctypes.c_int32)),
                    (ne.value,)).copy()
            else:
                exc = np.zeros(0, np.int32)
            header = ctypes.string_at(hdr, hlen.value).decode(
                "utf-8", "replace")
            yield header, words, slen.value, exc
    finally:
        lib.nq_reader_close(h)


def _as_np(ptr, n: int, ctype, np_dtype) -> np.ndarray:
    """A copy of n ``ctype`` values at ``ptr`` as a numpy array."""
    if n == 0:
        return np.zeros(0, np_dtype)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,)).astype(np_dtype,
                                                              copy=True)


def read_packed_records_chunked(path: str, K: int, ftype: str | None = None,
                                max_records: int = 1 << 15,
                                max_bases: int = 1 << 26):
    """Yield (header, packed_words, n_bases, exc_idx) per record like
    read_packed_records, through one native call per chunk of at most
    ``max_records`` records or ``max_bases`` bases; each record's arrays
    are views into the chunk's concatenated copies (a ctypes round trip
    per record costs more than the C++ work at read length)."""
    lib = _require()
    ft = {None: 0, "A": 1, "Q": 2}[ftype]
    h = lib.nq_reader_open(path.encode(), K, ft)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        pw, pwo, pnb, pe, peo, pho = (ctypes.c_void_p() for _ in range(6))
        ph = ctypes.c_char_p()
        while True:
            n = lib.nq_reader_next_chunk(
                h, max_records, max_bases, ctypes.byref(pw),
                ctypes.byref(pwo), ctypes.byref(pnb), ctypes.byref(pe),
                ctypes.byref(peo), ctypes.byref(ph), ctypes.byref(pho))
            if n == 0:
                return
            word_off = _as_np(pwo, n + 1, ctypes.c_int64, np.int64)
            n_bases = _as_np(pnb, n, ctypes.c_int64, np.int64)
            exc_off = _as_np(peo, n + 1, ctypes.c_int64, np.int64)
            header_off = _as_np(pho, n + 1, ctypes.c_int64, np.int64)
            nw, ne = int(word_off[-1]), int(exc_off[-1])
            words = hostmem.big_empty((nw,), np.uint32)
            if nw:
                np.copyto(words, np.ctypeslib.as_array(
                    ctypes.cast(pw, ctypes.POINTER(ctypes.c_uint32)), (nw,)))
            exc = _as_np(pe, ne, ctypes.c_int32, np.int32)
            headers = ctypes.string_at(ph, int(header_off[-1]))
            for i in range(n):
                yield (headers[header_off[i]:header_off[i + 1]].decode(
                           "utf-8", "replace"),
                       words[word_off[i]:word_off[i + 1]],
                       int(n_bases[i]),
                       exc[exc_off[i]:exc_off[i + 1]])
    finally:
        lib.nq_reader_close(h)


def read_packed_files(paths, K: int, max_threads: int):
    """Every record (len > K) of each file, read and packed in one native
    call that releases the GIL once, on min(max_threads, len(paths))
    native threads: ``(files, threads)``, where files[i] is the list of
    (packed_words, n_bases, exc_idx) records of paths[i], as
    read_packed_records yields them without the header, or the OSError
    that file gave (it could not be opened). Each record's arrays are
    views into the window's concatenated copies. A file that is not a
    regular file, or a gzip file that is not a run of whole members (a
    truncated one, trailing bytes), is read by read_packed_records."""
    lib = _require()
    n = len(paths)
    rec_off = np.zeros(n + 1, np.int64)
    status = np.zeros(max(n, 1), np.int32)
    kinds = (np.uint32, np.int64, np.int64, np.int32, np.int64)
    arrays: list = [None] * len(kinds)

    def alloc(kind: int, count: int) -> int:
        arr = np.empty(max(count, 1), kinds[kind])
        arrays[kind] = arr[:count]
        return arr.ctypes.data

    cb = _ALLOC(alloc)
    c_paths = (ctypes.c_char_p * max(n, 1))(*map(os.fsencode, paths))
    threads = lib.nq_read_packed_files(c_paths, n, K, max(1, max_threads),
                                       cb, rec_off, status)
    if threads < 0:
        raise MemoryError("read_packed_files: no memory for the records")
    words, exc = arrays[0], arrays[3]
    wo, nb, eo = (arrays[k].tolist() for k in (1, 2, 4))
    ro = rec_off.tolist()
    files: list = []
    for i, path in enumerate(paths):
        if status[i] == 0:
            files.append([(words[wo[r]:wo[r + 1]], nb[r],
                           exc[eo[r]:eo[r + 1]])
                          for r in range(ro[i], ro[i + 1])])
        elif status[i] == -1:
            files.append(OSError(f"cannot open {path}"))
        elif status[i] == -2:
            files.append(OSError(f"out of memory reading {path}"))
        else:
            try:
                files.append([(w, nw, e) for _, w, nw, e
                              in read_packed_records(path, K)])
            except OSError as err:
                files.append(err)
    return files, int(threads)


def _concat_recs(recs):
    """(words, word_off, n_bases, exc, exc_off) concatenated wire arrays of
    packed (words, n_bases, exc_idx) records."""
    B = len(recs)
    words = np.concatenate([np.ascontiguousarray(r[0], np.uint32)
                            for r in recs])
    word_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(r[0]) for r in recs], out=word_off[1:])
    n_bases = np.array([r[1] for r in recs], np.int64)
    excs = [np.ascontiguousarray(r[2], np.int32) for r in recs]
    exc = np.concatenate(excs) if any(len(e) for e in excs) \
        else np.zeros(1, np.int32)
    exc_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(e) for e in excs], out=exc_off[1:])
    return words, word_off, n_bases, exc, exc_off


def sketch_packed_whole(recs, lF: int, K: int, W: int, H: int,
                        mask_M: int, max_rem: int) -> np.ndarray:
    """Whole-file sketch of packed (words, n_bases, exc_idx) records: the
    per-record min-merge with densify after each record, on the host's
    rolling sketcher. The GIL is released."""
    lib = _require()
    out = np.empty(1 << lF, np.int32)
    if not recs:
        out.fill(-1)
        return out
    lib.nq_sketch_packed_whole(*_concat_recs(recs), len(recs), K, lF, W, H,
                               mask_M, max_rem, out)
    return out


def sketch_packed_batch(recs, lF: int, K: int, W: int, H: int,
                        mask_M: int, max_rem: int) -> np.ndarray:
    """(B, F) final sketches (-1 empty, densified) of packed (words,
    n_bases, exc_idx) records, each on its own, in one native call on the
    host's rolling sketcher. The GIL is released."""
    lib = _require()
    B = len(recs)
    out = hostmem.big_empty((B, 1 << lF), np.int32)
    if B == 0:
        return out
    lib.nq_sketch_packed_batch(*_concat_recs(recs), B, K, lF, W, H,
                               mask_M, max_rem, out)
    return out


def sketch_codes_cpu(eff_fwd: np.ndarray, eff_rc: np.ndarray,
                     lF: int, K: int, W: int, H: int,
                     mask_M: int | None = None, max_rem: int | None = None,
                     table: np.ndarray | None = None) -> np.ndarray:
    """The host's rolling sketch of one record's code arrays, min-merged
    into ``table`` (INT32_MAX empty; a new table where None): the device
    sketch's table before densify. mask_M and max_rem default to the values
    H gives; the -G path passes the stale constants."""
    lib = _require()
    if table is None:
        table = np.full(1 << lF, np.iinfo(np.int32).max, np.int32)
    if table.dtype != np.int32 or not table.flags.c_contiguous \
            or table.shape != (1 << lF,):
        raise ValueError("sketch_codes_cpu takes a contiguous (2^lF,) int32 "
                         "table")
    if mask_M is None:
        mask_M = (1 << (W - H)) - 1
    if max_rem is None:
        max_rem = (1 << H) - 1
    eff_fwd = np.ascontiguousarray(eff_fwd, np.uint8)
    eff_rc = np.ascontiguousarray(eff_rc, np.uint8)
    if eff_rc.shape != eff_fwd.shape or eff_fwd.ndim != 1:
        raise ValueError(f"code arrays of shapes {eff_fwd.shape} and "
                         f"{eff_rc.shape}")
    lib.nq_sketch_codes(eff_fwd, eff_rc, len(eff_fwd), K, lF, W, H, mask_M,
                        max_rem, table)
    return table


def sketch_stage_bench(words: np.ndarray, n_bases: int, lF: int, K: int,
                       W: int, H: int, reps: int = 5) -> dict:
    """Nanoseconds a window of each stage of the host sketcher over one
    packed record, best of ``reps``: the canonical roll (``roll_ns``), with
    the hash, fingerprint and slot (``roll_hash_ns``), and the whole sketch
    with its min-scatter (``full_ns``); ``hash_ns`` and ``scatter_ns`` are
    the differences."""
    lib = _require()
    words = np.ascontiguousarray(words, np.uint32)
    if n_bases > 16 * len(words):
        raise ValueError(f"{n_bases} bases in {len(words)} packed words")
    out = np.zeros(3, np.float64)
    r = lib.nq_sketch_stage_bench(words,
                                  n_bases, K, lF, W, H, (1 << (W - H)) - 1,
                                  (1 << H) - 1, reps, out)
    if r < 0:
        raise ValueError("record too short")
    return {"roll_ns": out[0], "roll_hash_ns": out[1], "full_ns": out[2],
            "scatter_ns": out[2] - out[1], "hash_ns": out[1] - out[0]}


def scan_dump_sizes(words: np.ndarray, n_buckets: int) -> np.ndarray:
    """The n_buckets bucket sizes (uint32) of a NIQKI dump's
    [size][gids...] stream; raises ValueError where the stream is
    truncated."""
    lib = _require()
    words = np.ascontiguousarray(words, np.uint32)
    sizes = np.empty(n_buckets, np.uint32)
    if lib.nq_scan_dump_sizes(words, len(words), n_buckets, sizes) < 0:
        raise ValueError("truncated dump bucket stream")
    return sizes


_gz_tls = threading.local()


def gzip_member(data, level: int = 6) -> bytes | None:
    """One gzip member of ``data`` (bytes or a memoryview) at ``level``:
    libdeflate where the library was built with it, else zlib inside the
    library. Only the decompressed bytes are the contract. Thread-safe (the
    writer deflates on a pool); each thread keeps its output buffer, so
    members do not first-touch fresh pages. None where the library is not
    loaded or the member does not fit the bound."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    cap = int(lib.nq_gzip_bound(src.size, level))
    buf = getattr(_gz_tls, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.empty(max(cap, 1 << 20), np.uint8)
        _gz_tls.buf = buf
    m = lib.nq_gzip_member(src.ctypes.data, src.size, level,
                           buf.ctypes.data, buf.size)
    return None if m < 0 else buf[:m].tobytes()


def densify(sketch: np.ndarray) -> None:
    """In-place densification of one (F,) int32 sketch (-1 empty)."""
    lib = _require()
    if sketch.dtype != np.int32 or not sketch.flags.c_contiguous:
        raise ValueError("densify takes a contiguous int32 sketch")
    lib.nq_densify(sketch, sketch.shape[0])


def count_eq(q: np.ndarray, mat: np.ndarray, fp_range: int) -> np.ndarray:
    """Host equality counts (Q, G) int32 of raw query sketches q (Q, F)
    against the stored-side matrix mat (G, F) (bad slots already -2), with
    the reference's query-side range guard (out-of-range query fingerprints
    match nothing) applied in C++. Blocks of queries run on a thread pool
    (the C call releases the GIL)."""
    lib = _require()
    q = np.ascontiguousarray(q, np.int32)
    mat = np.ascontiguousarray(mat, np.int32)
    Q, F = q.shape
    G = mat.shape[0]
    if mat.shape[1] != F:
        raise ValueError(f"query width {F} != index width {mat.shape[1]}")
    out = hostmem.big_empty((Q, G), np.int32)
    if Q == 0 or G == 0:
        return out
    threads = min(8, os.cpu_count() or 1)
    block = max(64, -(-Q // threads))
    if Q <= block:
        lib.nq_count_eq(q, Q, mat, G, F, fp_range, out)
        return out

    def run(lo: int) -> None:
        hi = min(lo + block, Q)
        lib.nq_count_eq(q[lo:hi], hi - lo, mat, G, F, fp_range, out[lo:hi])

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(run, range(0, Q, block)))
    return out


def pack_bitplanes(mat: np.ndarray, W: int, out: np.ndarray) -> bool:
    """Bit-plane pack of (N, F) int32 rows into ``out``, a (W+1, N, F/32)
    uint32 array or view whose last two axes are C-contiguous (the plane
    stride may exceed N*F/32: a row slice of larger planes). Bit p < W of
    lane l of row n holds bit p of mat[n, 32l + j] at bit j, 0 where the
    value lies outside [0, 2^W); plane W is 1 there. AVX-512 where the
    library was built for it, else a scalar loop with the same bits; the
    GIL is released. Returns False where the library is not loaded or the
    layout does not fit."""
    lib = _load()
    if lib is None:
        return False
    m = np.ascontiguousarray(mat, np.int32)
    N, F = m.shape
    L = F // 32
    if out.dtype != np.uint32 or out.shape != (W + 1, N, L):
        return False
    s0, s1, s2 = out.strides
    if s2 != 4 or s1 != L * 4 or s0 % 4 != 0:
        return False
    return lib.nq_pack_bitplanes(m, N, F, W, out.ctypes.data, s0 // 4) == 0


class DumpStreamScanner:
    """Incremental scanner of a NIQKI dump's [size][gids...] bucket stream:
    ``feed`` uint32 word chunks and get (gids, buckets, consumed) back;
    ``done`` turns true once all ``n_buckets`` are consumed (the words
    after them are the names)."""

    def __init__(self, n_buckets: int):
        self._lib = _require()
        self.n_buckets = n_buckets
        self._bucket = ctypes.c_int64(0)
        self._remaining = ctypes.c_int64(0)

    @property
    def done(self) -> bool:
        return self._bucket.value >= self.n_buckets

    def feed(self, words: np.ndarray):
        words = np.ascontiguousarray(words, np.uint32)
        gids = np.empty(len(words), np.uint32)
        buckets = np.empty(len(words), np.int64)
        consumed = ctypes.c_int64(0)
        n = self._lib.nq_scan_dump_stream(
            words, len(words), self.n_buckets,
            ctypes.byref(self._bucket), ctypes.byref(self._remaining),
            ctypes.byref(consumed), gids, buckets)
        return gids[:n], buckets[:n], consumed.value


class _FmtBuf:
    """Grow-only output buffer reused across a formatter's calls (a fresh
    buffer per block would be zeroed and first-touched every time)."""

    def __init__(self):
        self._cap = 0
        self._buf = None

    def get(self, cap: int):
        if cap > self._cap:
            self._cap = max(cap, self._cap * 2)
            self._buf = ctypes.create_string_buffer(self._cap)
        return self._buf


class _Names:
    """The index's names as one blob with offsets, kept across blocks."""

    def __init__(self, names, F: int, min_score: int):
        self._lib = _require()
        self.F = F
        self.min_score = min_score
        blobs = [str(n).encode() for n in names]
        self._names = b"".join(blobs)
        self._name_off = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=self._name_off[1:])
        self._max_name = max((len(b) for b in blobs), default=0)
        self.G = len(blobs)
        self._obuf = _FmtBuf()

    @staticmethod
    def _headers(headers):
        hb = [h.encode() for h in headers]
        hoff = np.zeros(len(hb) + 1, np.int64)
        np.cumsum([len(b) for b in hb], out=hoff[1:])
        return b"".join(hb), hoff


class HitsFormatter(_Names):
    """Pretty-hit rows formatted in C++, byte-identical with
    ``io.writers.write_pretty_hits`` over ``index.hits_from_counts``."""

    def format(self, counts: np.ndarray, headers: list[str]) -> bytes:
        with span("emit.format", 2) as sp:
            counts = np.ascontiguousarray(counts, np.int32)
            B, G = counts.shape
            if G != self.G or B != len(headers):
                raise ValueError(f"counts {counts.shape} for {self.G} names "
                                 f"and {len(headers)} headers")
            hblob, hoff = self._headers(headers)
            nhits = int((counts >= self.min_score).sum())
            cap = len(hblob) + 2 * B + nhits * (self._max_name + 16) + 64
            out = self._obuf.get(cap)
            n = self._lib.nq_format_hits(counts, B, G, self.min_score, self.F,
                                         self._names, self._name_off, hblob,
                                         hoff, out, cap)
            if n < 0:
                raise RuntimeError("nq_format_hits capacity underestimated")
            if sp:
                sp.set(rows=len(headers), bytes=n)
            return ctypes.string_at(out, n)

    def format_sparse(self, vals: np.ndarray, idx: np.ndarray,
                      headers: list[str]) -> bytes:
        """Rows from top-k (vals, idx) (B, cap) survivors: byte-identical
        with format() whenever each row's survivors fit in cap (callers
        re-fetch overflowing rows dense)."""
        with span("emit.format", 2) as sp:
            vals = np.ascontiguousarray(vals, np.int32)
            idx = np.ascontiguousarray(idx, np.int32)
            B, kcap = vals.shape
            if B != len(headers):
                raise ValueError(f"{B} rows for {len(headers)} headers")
            hblob, hoff = self._headers(headers)
            nhits = int((vals >= self.min_score).sum())
            cap = len(hblob) + 2 * B + nhits * (self._max_name + 16) + 64
            out = self._obuf.get(cap)
            n = self._lib.nq_format_hits_sparse(
                vals, idx, B, kcap, self.G, self.min_score, self.F,
                self._names, self._name_off, hblob, hoff, out, cap)
            if n < 0:
                raise RuntimeError("nq_format_hits_sparse failed: capacity "
                                   "or survivor contract violated")
            if sp:
                sp.set(rows=len(headers), bytes=n)
            return ctypes.string_at(out, n)


class MatrixFormatter(_Names):
    """All-vs-all matrix rows formatted in C++, byte-identical with
    ``io.writers.write_matrix_row`` over full count rows: from top-k
    survivors (min_score >= 1) or from dense (B, G) uint16 wrapped
    counts."""

    def format_sparse(self, vals: np.ndarray, idx: np.ndarray,
                      row0: int) -> bytes:
        vals = np.ascontiguousarray(vals, np.int32)
        idx = np.ascontiguousarray(idx, np.int32)
        B, cap = vals.shape
        nsurv = int((vals >= self.min_score).sum())
        out_cap = 2 * B * self.G + nsurv * 14 + B * (self._max_name + 4) + 64
        out = self._obuf.get(out_cap)
        n = self._lib.nq_format_matrix_sparse(
            vals, idx, B, cap, self.G, self.F, self.min_score,
            self._names, self._name_off, row0, out, out_cap)
        if n < 0:
            raise RuntimeError(f"nq_format_matrix_sparse failed ({n}): "
                               "capacity or survivor contract violated")
        return ctypes.string_at(out, n)

    def format_dense(self, counts: np.ndarray, row0: int) -> bytes:
        counts = np.ascontiguousarray(counts, np.uint16)
        B, G = counts.shape
        if G != self.G:
            raise ValueError(f"{G} columns for {self.G} names")
        nnz = int((counts >= max(self.min_score, 1)).sum())
        out_cap = 2 * B * G + nnz * 14 + B * (self._max_name + 4) + 64
        out = self._obuf.get(out_cap)
        n = self._lib.nq_format_matrix_dense(
            counts, B, G, self.F, self.min_score,
            self._names, self._name_off, row0, out, out_cap)
        if n < 0:
            raise RuntimeError("nq_format_matrix_dense capacity "
                               "underestimated")
        return ctypes.string_at(out, n)
