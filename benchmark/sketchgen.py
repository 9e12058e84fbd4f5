"""Sketch rows of a clustered collection of bacterial genomes, drawn on the
device from ``--seed``, for cells that measure the index against itself
(``-M``) and never the sketcher.

Drawing and sketching tens of thousands of 4.6 Mbp genomes is far past a
run's set-up, so the rows are derived. ``clusters`` ancestors of
``length`` uniform random bases (``gen.generator``'s stream 1) are
sketched by the plain reference (``reference.sketches``). Each member of
a cluster keeps its ancestor's fingerprint in each slot independently,
with a probability q drawn per member uniform in ``keep`` = [lo, hi]
(stream 3); a slot it does not keep takes the same slot of another
ancestor, drawn per (member, slot) uniform among the other clusters. So
every value is a real HyperMinHash fingerprint of its slot, two members i
and j of one cluster share about q_i q_j of their slots, and members of
different clusters about what unrelated genomes share.

Rows are int16 (-1 empty; W <= 15), in cluster order; genome i is named
``c<cluster>_g<i>``. The shapes are the configuration's, never the
seed's: every seed gives the same amount of work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import gen
from . import reference as ref
from .common import reference_params

CHUNK_SLOTS = 1 << 25       # member slots drawn per step on the device


@dataclass
class Rows:
    """Sketch rows on the host: ``rows[i]`` is genome i's (F,) int16
    sketch, ``names`` carry no '>'."""
    names: list
    cluster: np.ndarray
    rows: np.ndarray

    @property
    def G(self) -> int:
        return len(self.names)


def ancestors(cfg: dict, seed: int, device) -> torch.Tensor:
    """(clusters, F) int16 reference sketches, on ``device``, of the
    configuration's random ancestor genomes."""
    gn = cfg["genomes"]
    C, L = gn["clusters"], gn["length"]
    g = gen.generator(seed, 1, device)
    codes = torch.randint(0, 4, (C * L,), generator=g, device=device,
                          dtype=torch.uint8).cpu().numpy()
    offsets = np.arange(C + 1, dtype=np.int64) * L
    return ref.sketches(codes, offsets, reference_params(cfg), device)


def make_rows(cfg: dict, seed: int, device) -> Rows:
    """The configuration's G sketch rows (see the module's text)."""
    gn = cfg["genomes"]
    G, C = gn["G"], gn["clusters"]
    lo, hi = gn["keep"]
    if C < 2:
        raise ValueError("the rows need at least two clusters")
    anc = ancestors(cfg, seed, device)
    F = anc.shape[1]
    cluster = np.repeat(np.arange(C, dtype=np.int32),
                        gen.cluster_sizes(G, C))
    g = gen.generator(seed, 3, device)
    q = lo + (hi - lo) * torch.rand(G, generator=g, device=device)
    own = torch.from_numpy(cluster).to(device).long()
    slots = torch.arange(F, device=device)
    rows = np.empty((G, F), np.int16)
    step = max(1, CHUNK_SLOTS // F)
    for a in range(0, G, step):
        b = min(G, a + step)
        keep = torch.rand((b - a, F), generator=g, device=device) \
            < q[a:b, None]
        other = torch.randint(1, C, (b - a, F), generator=g, device=device)
        src = torch.where(keep, own[a:b, None],
                          (own[a:b, None] + other) % C)
        rows[a:b] = anc[src, slots].cpu().numpy()
    wc, wg = gen._name_width(C), gen._name_width(G)
    names = [f"c{c:0{wc}d}_g{i:0{wg}d}" for i, c in enumerate(cluster)]
    return Rows(names, cluster, rows)
