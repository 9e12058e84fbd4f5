"""FASTA/FASTQ readers with gzip auto-detection, and file-of-files readers.

The port's counterpart of ``niqki_tpu/io/fasta.py``, with the reference's
record semantics:
  * the format is chosen by filename substring: ".fq" or ".fastq" anywhere
    means FASTQ, else FASTA (whatever the content);
  * FASTA: one header line, then all following lines concatenated until a
    line starting with '>' (or EOF); the file's first line is always a
    header, even without a '>';
  * FASTQ: strictly 4 lines per record, no validation;
  * only records longer than K are yielded;
  * gzip is detected by its magic bytes.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple


def data_type_of(filename: str) -> str:
    if ".fq" in filename or ".fastq" in filename:
        return "Q"
    return "A"


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return io.BufferedReader(f)


def records_from(f, K: int, ftype: str = "A"
                 ) -> Iterator[Tuple[str, bytes]]:
    """Yield (header, sequence_bytes) records longer than K from an open
    binary line stream; the header keeps its '>'/'@' and loses its
    newline."""
    if ftype == "Q":
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip(b"\n")
            f.readline()
            f.readline()
            if len(seq) > K:
                yield header.rstrip(b"\n").decode("utf-8", "replace"), seq
    else:
        header = f.readline()
        if not header:
            return
        while header:
            parts = []
            line = f.readline()
            while line and not line.startswith(b">"):
                parts.append(line.rstrip(b"\n"))
                line = f.readline()
            seq = b"".join(parts)
            if len(seq) > K:
                yield header.rstrip(b"\n").decode("utf-8", "replace"), seq
            header = line


def read_records(path: str, K: int,
                 ftype: str | None = None) -> Iterator[Tuple[str, bytes]]:
    """records_from over a (possibly gzipped) file path; format chosen by
    filename substring unless given."""
    with _open_maybe_gzip(path) as f:
        yield from records_from(f, K, ftype or data_type_of(path))


def read_fof(path: str) -> list[str]:
    """An INSERT file-of-files: one path per line; lines shorter than 3
    characters are ignored, as the reference's insert path does. Missing
    files are skipped by the callers (``exists``)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) > 2:
                out.append(line)
    return out


def read_query_fof(path: str) -> list[str]:
    """A QUERY file-of-files: every line as written (the reference's query
    path has no length filter)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def exists(path: str) -> bool:
    try:
        os.stat(path)
        return True
    except OSError:
        return False
