"""Output writers reproducing the reference's formats byte for byte.

The port's counterpart of ``niqki_tpu/io/writers.py``:
  * pretty hits:  "<query> <name>:<jac> <name>:<jac> ... \n" (trailing space)
  * binary hits:  "<query>\n" + uint32 nhits + per hit (uint32 gid, uint32
                  count)
  * matrix:       "##Names\t<n0>\t<n1>...\t\n" header, then per query a dense
                  tab-separated row of count/F values (trailing tab)

Floats print like a default C++ ostream (6 significant digits, fixed or
scientific, no trailing zeros), which is printf's %g with precision 6.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .. import native
from ..debug import carry, span


def format_double(v: float) -> str:
    """C++ `ostream << double` default formatting (= printf %.6g)."""
    return "%.6g" % v


class GzTextWriter:
    """Buffered gzip text writer.

    The output is a multi-member gzip stream: text accumulates into fixed
    4 MiB blocks, each deflated as an independent gzip member on a small
    thread pool (the deflate releases the GIL) and written in order. At
    close, the tail (the bytes after the last full BLOCK) is cut into
    members of PIECE input bytes and one shorter last member, all
    submitted to the pool at once, so a short output (a ``-Q`` call's
    hits) deflates in parallel rather than as one member on one thread;
    an empty file still gets one member. The decompressed bytes equal a
    single-member stream's, and standard tools read multi-member streams.
    Member boundaries depend only on the bytes written (BLOCK multiples,
    then PIECE multiples after the last of them), never on the write()
    sizes, so the output is deterministic for one level and one library.
    Members deflate through
    ``native.gzip_member`` (libdeflate where the library was built with
    it) where the native library is loaded, else through Python's zlib.
    The level is NIQKI_TPU_GZLEVEL, else 6, zlib's default and the
    reference's.
    """

    BLOCK = 4 << 20
    PIECE = 256 << 10

    def __init__(self, path: str):
        self.path = path
        self._level = int(os.environ.get("NIQKI_TPU_GZLEVEL", "6"))
        self._f = open(path, "wb")
        self._buf: list[bytes] = []
        self._size = 0
        self._members = 0
        self._pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count()
                                                        or 1))
        self._futs = deque()

    @staticmethod
    def _member(data, level: int) -> bytes:
        with span("writer.deflate", 2) as sp:
            if sp:
                sp.set(bytes=len(data))
            out = native.gzip_member(data, level)
            if out is not None:
                return out
            co = zlib.compressobj(level, zlib.DEFLATED, 31)  # gzip wrapper
            return co.compress(data) + co.flush()

    def _drain(self, all_: bool = False) -> None:
        while self._futs and (all_ or len(self._futs) > 16
                              or self._futs[0].done()):
            fut = self._futs.popleft()
            if not fut.done():
                with span("writer.wait", 2):
                    fut.result()
            self._f.write(fut.result())

    def _submit(self, blk) -> None:
        self._futs.append(self._pool.submit(carry(self._member), blk,
                                            self._level))
        self._members += 1

    def write(self, s: str | bytes) -> None:
        if isinstance(s, str):
            s = s.encode()
        elif not isinstance(s, bytes):
            s = bytes(s)   # the deflate threads read it after write returns
        self._buf.append(s)
        self._size += len(s)
        if self._size >= self.BLOCK:
            # cut members by offset over one immutable buffer (slicing off
            # the front per member would recopy the remainder each time)
            data = self._buf[0] if len(self._buf) == 1 else b"".join(self._buf)
            mv = memoryview(data)
            off = 0
            while len(data) - off >= self.BLOCK:
                self._submit(mv[off:off + self.BLOCK])
                self._drain()
                off += self.BLOCK
            tail = bytes(mv[off:])
            self._buf = [tail] if tail else []
            self._size = len(tail)

    def close(self) -> None:
        if self._f is None:
            return
        with span("writer.close", 2) as s:
            tail = b"".join(self._buf)
            self._buf = []
            mv = memoryview(tail)
            # an empty file still gets a member
            cuts = range(0, len(tail), self.PIECE) or (
                [0] if self._members == 0 else [])
            for lo in cuts:
                self._submit(mv[lo:lo + self.PIECE])
            if s:
                s.set(members=len(cuts))
            self._drain(all_=True)
            self._pool.shutdown()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_pretty_hits(out: GzTextWriter, query_name: str, hits, names, F: int):
    """hits: iterable of (count, gid) already sorted (count desc, gid desc)."""
    parts = [query_name, " "]
    for count, gid in hits:
        parts.append(f"{names[gid]}:{format_double(count / F)} ")
    parts.append("\n")
    out.write("".join(parts))


def write_binary_hits(out: GzTextWriter, query_name: str, hits):
    out.write(query_name + "\n")
    out.write(struct.pack("<I", len(hits)))
    for count, gid in hits:
        out.write(struct.pack("<II", gid, count))


def write_matrix_header(out: GzTextWriter, names):
    out.write("##Names\t" + "".join(str(n) + "\t" for n in names) + "\n")


def matrix_row_text(query_name: str, row, F: int, min_score: int) -> str:
    """One matrix row of dense per-genome counts (any int sequence)."""
    parts = [query_name, "\t"]
    for c in row:
        v = (c / F) if c >= min_score else 0.0
        parts.append(format_double(v) + "\t")
    parts.append("\n")
    return "".join(parts)


def write_matrix_row(out: GzTextWriter, query_name: str, row, F: int,
                     min_score: int):
    """row: dense per-genome counts (any int sequence)."""
    out.write(matrix_row_text(query_name, row, F, min_score))
