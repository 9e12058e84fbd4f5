"""Seeded inputs of the benchmark: clustered genomes and mutant queries.

The shapes of a configuration are fixed by its file and never by the seed:
how many clusters, of equal size, and the genomes' length. ``--seed``
draws only the bases: each cluster's random ancestor, each descendant's
iid point mutations (the replacement base uniform, the same base
included) and which index genomes the queries copy. So every seed gives the same amount of work.

Bases are drawn on the device with a ``torch.Generator`` seeded from
``--seed``, in blocks of whole genomes, and come back to the host as 2-bit
codes (A=0, C=1, G=2, T=3), one byte each; the FASTA files are written from
those codes, and the plain reference reads the same codes.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

ASCII = np.frombuffer(b"ACGT", np.uint8)
BLOCK_BASES = 1 << 26       # bases drawn per block of whole genomes


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed: streams of one
    seed never overlap, and any whole number is a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream * 0x632BE5AB)
                  % (1 << 63))
    return g


def cluster_sizes(G: int, clusters: int) -> np.ndarray:
    """Genomes per cluster, summing to G: equal shares, the first
    G % clusters clusters one more."""
    n = np.full(clusters, G // clusters, np.int64)
    n[:G % clusters] += 1
    return n


@dataclass
class Genomes:
    """Genomes as 2-bit codes on the host: genome i is
    ``codes[offsets[i]:offsets[i + 1]]``; ``names`` carry no '>'."""
    names: list
    cluster: np.ndarray
    offsets: np.ndarray
    codes: np.ndarray

    @property
    def G(self) -> int:
        return len(self.names)

    @property
    def bases(self) -> int:
        return int(self.offsets[-1])

    def seq(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]:self.offsets[i + 1]]

    def write_fasta(self, path: str, gz: bool = False) -> int:
        """The genomes as one multi-FASTA, one line of bases each; returns
        the bases written. ``gz`` writes it as gzip members of blocks of
        whole records, compressed at level 1 on a pool of threads (a
        third of the bytes on disk)."""
        text = memoryview(ASCII[self.codes])

        def block(a: int, b: int) -> bytes:
            out = bytearray()
            for i in range(a, b):
                lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
                out += b">%s\n" % self.names[i].encode()
                out += text[lo:hi]
                out += b"\n"
            return zlib_member(out) if gz else bytes(out)

        step = max(1, self.G * BLOCK_BASES // max(1, self.bases))
        starts = list(range(0, self.G, step))
        with open(path, "wb") as f, ThreadPoolExecutor(8) as pool:
            for part in pool.map(block, starts, [*starts[1:], self.G]):
                f.write(part)
        return self.bases

    def write_each(self, directory: str) -> list:
        """Each genome as a FASTA file of its own, named ``<name>.fa`` in
        ``directory``; returns the paths in genome order."""
        os.makedirs(directory, exist_ok=True)
        paths = [os.path.join(directory, n + ".fa") for n in self.names]

        def write(i: int) -> None:
            with open(paths[i], "wb") as f:
                f.write(b">%s\n%s\n" % (self.names[i].encode(),
                                        ASCII[self.seq(i)].tobytes()))

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write, range(self.G)))
        return paths


def zlib_member(data) -> bytes:
    """``data`` as one gzip member at level 1."""
    c = zlib.compressobj(1, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def _mutate(src_flat: torch.Tensor, src_index: torch.Tensor, rate: float,
            g: torch.Generator) -> torch.Tensor:
    """Bases src_flat[src_index], each replaced with probability ``rate`` by
    a uniform base (the same one included)."""
    T = src_index.numel()
    dev = src_flat.device
    mut = torch.rand(T, generator=g, device=dev) < rate
    alt = torch.randint(0, 4, (T,), generator=g, device=dev,
                        dtype=torch.uint8)
    return torch.where(mut, alt, src_flat[src_index])


def _descend(src_flat: torch.Tensor, src_start: np.ndarray,
             lengths: np.ndarray, rate: float, g: torch.Generator
             ) -> np.ndarray:
    """Genome i copies src_flat[src_start[i]: src_start[i] + lengths[i]]
    with point mutations; blocks of whole genomes of at most BLOCK_BASES
    bases (a longer genome alone) are drawn in a few calls each. Returns
    the concatenated codes on the host."""
    dev = src_flat.device
    out = np.empty(int(lengths.sum()), np.uint8)
    ends = np.cumsum(lengths)
    a, o = 0, 0
    while a < len(lengths):
        b = max(a + 1, int(np.searchsorted(ends, o + BLOCK_BASES,
                                           side="right")))
        ln = torch.from_numpy(lengths[a:b]).to(dev)
        T = int(lengths[a:b].sum())
        seg = torch.repeat_interleave(torch.arange(b - a, device=dev), ln)
        first = torch.cumsum(ln, 0) - ln
        pos = torch.arange(T, device=dev) - first[seg]
        idx = torch.from_numpy(src_start[a:b]).to(dev)[seg] + pos
        out[o:o + T] = _mutate(src_flat, idx, rate, g).cpu().numpy()
        a, o = b, o + T
    return out


def _name_width(n: int) -> int:
    return len(str(max(n - 1, 0)))


def make_genomes(cfg: dict, seed: int, device) -> Genomes:
    """The configuration's genomes: ``clusters`` random ancestors, each
    expanded into its share of ``G`` descendants by iid point mutations at
    ``mutation``, in cluster order, named ``c<cluster>_g<gid>``."""
    G, C = cfg["G"], cfg["clusters"]
    sizes = cluster_sizes(G, C)
    lens = np.full(C, cfg["length"], np.int64)
    g = generator(seed, 1, device)
    anc = torch.randint(0, 4, (int(lens.sum()),), generator=g,
                        device=device, dtype=torch.uint8)
    anc_start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    cluster = np.repeat(np.arange(C, dtype=np.int32), sizes)
    lengths = lens[cluster]
    codes = _descend(anc, anc_start[cluster], lengths, cfg["mutation"], g)
    wc, wg = _name_width(C), _name_width(G)
    names = [f"c{c:0{wc}d}_g{i:0{wg}d}" for i, c in enumerate(cluster)]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return Genomes(names, cluster, offsets, codes)


def make_queries(genomes: Genomes, n: int, rate: float, seed: int,
                 device, stream: int = 2) -> tuple[Genomes, np.ndarray]:
    """``n`` queries, each a copy of an index genome drawn from the seed
    with iid point mutations at ``rate``, named ``q<i>``. Returns the
    queries and the index genome each copies."""
    g = generator(seed, stream, device)
    src = torch.randint(0, genomes.G, (n,), generator=g,
                        device=device).cpu().numpy()
    flat = torch.from_numpy(genomes.codes).to(device)
    lengths = np.diff(genomes.offsets)[src]
    codes = _descend(flat, genomes.offsets[src], lengths, rate, g)
    del flat
    names = [f"q{i:0{_name_width(n)}d}" for i in range(n)]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return Genomes(names, genomes.cluster[src], offsets, codes), src
