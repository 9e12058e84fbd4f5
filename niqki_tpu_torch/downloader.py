"""Streaming NCBI ingest (``-Iddl``): download, sketch, insert, nothing kept
on disk.

The port's counterpart of ``niqki_tpu/downloader.py``, the rework of the
reference's ``popen("wget | gzip -d")`` pipeline: a thread pool streams and
gunzips assemblies with urllib + zlib, parses FASTA records incrementally
and sketches them in the worker; entries are inserted in fof order.

Each accession URL <base> resolves to <base>/<name>_genomic.fna.gz where
<name> is the last path component, as the reference's get_name_ncbi finds
it.
"""

from __future__ import annotations

import concurrent.futures as cf
import http.client
import urllib.request
import zlib


def name_of_accession_url(url: str) -> str:
    """The reference's get_name_ncbi: the name starts after the last '/'
    at positions [0, len-4], so a slash within the final 3 characters is
    never seen (a trailing-slash URL keeps it, and its fetch fails as the
    reference's does), and a URL without one loses its first character."""
    last = 0
    for i in range(max(len(url) - 3, 0)):
        if url[i] == "/":
            last = i
    return url[last + 1:]


def _iter_contigs(url: str, K: int, timeout: float, stats: dict):
    """The contigs of one accession, streamed: the gzip stream is inflated
    chunk by chunk (multi-member aware), so memory stays one contig. The
    reference's flush quirks are kept: a contig is flushed only when the
    next '>' line is seen, so the final contig is always dropped, and a
    contig of at most K bases is not cleared, so its bases prepend the next
    contig's. ``stats['bases']`` counts the bases flushed."""
    full = f"{url}/{name_of_accession_url(url)}_genomic.fna.gz"
    with urllib.request.urlopen(full, timeout=timeout) as resp:
        d = zlib.decompressobj(31)          # gzip wrapper
        sequence = bytearray()
        tail = b""

        def lines_of(data):
            nonlocal tail
            buf = tail + data if tail else data
            parts = buf.split(b"\n")
            tail = parts.pop()
            return parts

        def handle(line):
            nonlocal sequence
            if not line.startswith(b">"):
                sequence += line
                return None
            if len(sequence) > K:
                out = bytes(sequence)
                sequence = bytearray()
                stats["bases"] += len(out)
                return out
            return None

        while True:
            chunk = resp.read(1 << 18)
            if not chunk:
                break
            pieces = []
            while chunk:
                if d.eof:                   # the next gzip member
                    d = zlib.decompressobj(31)
                pieces.append(d.decompress(chunk))
                chunk = d.unused_data
            for line in lines_of(b"".join(pieces)):
                c = handle(line)
                if c is not None:
                    yield c
        if tail:                            # a final line without '\n'
            c = handle(tail)
            if c is not None:
                yield c


def download_ncbi_fof(index, fof_path: str, max_workers: int = 8,
                      timeout: float = 120.0,
                      progress_every: int = 1000) -> tuple[int, int]:
    """Download every accession of the fof (lines over 5 characters),
    sketch each in a worker as its contigs arrive, and insert it into
    ``index`` (a SketchIndex) in fof order under its URL. Returns (genomes,
    bases). Failed fetches are skipped silently, as the reference skips
    dead links."""
    with open(fof_path) as f:
        urls = [u.rstrip("\n") for u in f if len(u.rstrip("\n")) > 5]
    genomes = bases = 0
    K = index.params.K

    def work(url):
        stats = {"bases": 0}
        try:
            sketch = index.sketch_records(_iter_contigs(url, K, timeout,
                                                        stats))
        except (OSError, EOFError, ValueError, zlib.error,
                http.client.HTTPException):
            return None             # dead link, bad URL or gzip: skipped
        return sketch, stats["bases"]

    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        for url, result in zip(urls, pool.map(work, urls)):
            if not result or not result[1]:
                continue
            sketch, total = result
            index.insert_sketch(sketch, url)
            genomes += 1
            bases += total
            if genomes % progress_every == 0:
                print(f"#genomes downloaded: {genomes:,} "
                      f"#bases downloaded: {bases:,}")
    print(f"#genomes downloaded: {genomes:,} #bases downloaded: {bases:,}")
    return genomes, bases
