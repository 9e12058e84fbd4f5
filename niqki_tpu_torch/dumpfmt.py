"""NIQKI-compatible index dump format (-D / -L).

The port's copy of ``niqki_tpu/dumpfmt.py``. Byte layout (gzip-wrapped,
little-endian, every field uint32), the reference binary's own dump:

    lF, K, H, W, min_score, genome_numbers
    for each of F * 2^W flat buckets (flat key = fp + slot * 2^W):
        uint32 size, then ``size`` uint32 genome ids
    genome_numbers newline-terminated name strings

Every indexed genome holds exactly one fingerprint per slot (sketches are
fully densified), so each slot's buckets partition the genome ids; this
module converts between that inverted layout and the dense (G, F)
fingerprint matrix of ``SketchIndex``. Host numpy only.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from . import hostmem, native
from .params import SketchParams


class DumpHeader:
    def __init__(self, lF, K, H, W, min_score, genome_numbers):
        self.lF, self.K, self.H, self.W = lF, K, H, W
        self.min_score, self.genome_numbers = min_score, genome_numbers

    def params(self) -> SketchParams:
        # the dump stores min_score, not min_fract: rebuild a value that
        # truncates back to the stored min_score exactly
        F = 1 << self.lF
        return SketchParams(
            lF=self.lF, K=self.K, W=self.W, H=self.H,
            min_fract=self.min_score / F if self.min_score else 0.0,
        )


def load_dump(path: str, chunk_words: int = 1 << 24):
    """Parse a NIQKI dump into (header, fingerprint matrix, names).

    The matrix is (G, F) int32; a slot where a genome id never appears
    (impossible in a fully densified index) stays -1. The gzip stream is
    read in ``chunk_words`` pieces through the native incremental scanner,
    so peak memory is the matrix plus one chunk, not the decompressed dump
    (about (1 + G / 2^W) * F * 2^W words). Without the native library the
    whole stream is parsed at once. A stream that ends inside the buckets
    raises ValueError."""
    with gzip.open(path, "rb") as f:
        lF, K, H, W, min_score, G = struct.unpack_from("<6I", f.read(24), 0)
        hdr = DumpHeader(lF, K, H, W, min_score, G)
        F = 1 << lF
        fr = 1 << W
        n_buckets = F * fr
        sk = np.full((G, F), -1, dtype=np.int32)
        if native.available():
            scanner = native.DumpStreamScanner(n_buckets)
            tail = b""
            name_blob = []
            while True:
                data = f.read(4 * chunk_words)
                if not data:
                    break
                if scanner.done:
                    name_blob.append(data)
                    continue
                data = tail + data
                usable = len(data) // 4 * 4
                tail = data[usable:]
                words = np.frombuffer(data, dtype="<u4", count=usable // 4)
                gids, buckets, consumed = scanner.feed(words)
                if len(gids):
                    sk[gids.astype(np.int64), buckets // fr] = \
                        (buckets % fr).astype(np.int32)
                if consumed < len(words):
                    name_blob.append(data[4 * consumed:])
                    tail = b""
            if not scanner.done:
                # an index with missing fingerprints must not load silently
                raise ValueError("truncated dump bucket stream")
            names_raw = tail + b"".join(name_blob)
        else:
            data = f.read()
            words = np.frombuffer(data, dtype="<u4", count=len(data) // 4)
            sizes = np.empty(n_buckets, dtype=np.int64)
            pos = 0
            for k in range(n_buckets):
                if pos >= len(words):
                    raise ValueError("truncated dump bucket stream")
                s = int(words[pos])
                sizes[k] = s
                pos += 1 + s
            if pos > len(words):
                raise ValueError("truncated dump bucket stream")
            total = int(sizes.sum())
            bucket_of_gid = np.repeat(
                np.arange(n_buckets, dtype=np.int64), sizes)
            gid_words = words[np.arange(total, dtype=np.int64)
                              + bucket_of_gid + 1]
            sk[gid_words.astype(np.int64), bucket_of_gid // fr] = \
                (bucket_of_gid % fr).astype(np.int32)
            names_raw = data[4 * pos:]
    names = names_raw.decode("utf-8", errors="replace").split("\n")[:G]
    return hdr, sk, names


def save_dump(path: str, p: SketchParams, sketches: np.ndarray, names) -> None:
    """Write a NIQKI-compatible dump of a dense (G, F) fingerprint matrix.

    Genome ids within a bucket ascend, the reference's insertion order
    under its deterministic single-thread id assignment."""
    G, F = sketches.shape if sketches.size else (0, p.F)
    fr = p.fingerprint_range
    n_buckets = p.F * fr
    header = struct.pack("<6I", p.lF, p.K, p.H, p.W, p.min_score, G)
    if G:
        valid = (sketches >= 0) & (sketches < fr)
        flat = (np.arange(F, dtype=np.int64)[None, :] * fr
                + sketches.astype(np.int64))
        # slot-major, then gid-minor: transpose before raveling
        keys = flat.T.ravel()
        gids = np.broadcast_to(
            np.arange(G, dtype=np.uint32)[None, :], (F, G)).ravel()
        ok = valid.T.ravel()
        keys, gids = keys[ok], gids[ok]
        order = np.argsort(keys, kind="stable")
        keys, gids = keys[order], gids[order]
        # the stream has 2^(S+W) size words but at most G*F nonzero ones:
        # big_zeros leaves the pages the scatter never reaches untouched
        out_words = hostmem.big_zeros(n_buckets + len(gids), "<u4")
        uniq, cnt = np.unique(keys, return_counts=True)  # keys are sorted
        gid_before = np.zeros(len(uniq), np.int64)
        np.cumsum(cnt[:-1], out=gid_before[1:])
        out_words[uniq + gid_before] = cnt.astype("<u4")
        out_words[np.arange(len(gids), dtype=np.int64) + keys + 1] = gids
    else:
        out_words = hostmem.big_zeros(n_buckets, "<u4")
    name_blob = "".join(str(n) + "\n" for n in names).encode()
    # level 1: the format is compared on decompressed bytes, and a higher
    # level costs minutes on the mostly-zero stream at S=18
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(header)
        mv = memoryview(out_words).cast("B")
        chunk = 64 << 20     # bounded gzip input (no whole-stream copy)
        for lo in range(0, len(mv), chunk):
            f.write(mv[lo:lo + chunk])
        f.write(name_blob)
