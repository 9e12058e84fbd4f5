"""Sharded sketch and count pipelines over a ('dp', 'tp') mesh.

The counterpart of ``niqki_tpu/parallel/sharded.py``, as plain functions
on tensors with explicit devices and the shard loops in Python (no
``shard_map``):

  * DP  - query and ingest batches split on 'dp';
  * TP  - the index's genome rows split on 'tp', each shard counted on its
          own device, the count blocks assembled on the mesh's first
          device;
  * SP  - sequences split into chunks overlapping by K codes on 'tp'; each
          chunk sketches on its own, and one min over the chunks merges the
          per-slot minima (the JAX package's ``pmin``);
  * EP  - a batch insert routes rows to the owning 'tp' shard after the dp
          slices are gathered; rows owned by another shard are dropped.

Each shard counts with the port's own kernels: K2 (``bcount._bcount_call``)
on bit-planes, K3 (``pcount._count_call``) on pair-packed rows, and the
sketch sorts with K1 per device. On the CPU they take their plain
versions, as everywhere in the port. An index shard held by several
devices of one column that are the same device (virtual devices) is one
tensor, not a copy per replica.

Each function returns a function, as the JAX package's return jitted ones,
and the sharded index arrays are ``Sharded`` objects (``shard_index``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bcount, pcount
from ..ops.densify import densify_device
from ..ops.sketch import EXC_PAD, _batch_core, _codes_core


class Sharded:
    """An array split over a mesh's 'tp' axis and held by every 'dp' row:
    ``parts[d][t]`` is shard t on ``mesh.devices[d][t]``, split along
    ``axis`` (0 for (G, F) rows, 1 for (P, G, L) bit-planes). The JAX
    package's NamedSharding P('tp', None) and P(None, 'tp', None)."""

    def __init__(self, mesh, parts, axis: int):
        self.mesh = mesh
        self.parts = parts
        self.axis = axis

    @classmethod
    def from_pieces(cls, mesh, pieces, axis: int) -> "Sharded":
        """Piece t on every device (d, t). Where a device of column t is a
        device an earlier row already holds piece t on (virtual devices),
        the row takes that same tensor: the dp replicas are one tensor."""
        parts: list[list] = []
        for d, row in enumerate(mesh.devices):
            out = []
            for t, dev in enumerate(row):
                prev = next((parts[e][t] for e in range(d)
                             if mesh.devices[e][t] == dev), None)
                out.append(prev if prev is not None else pieces[t].to(dev))
            parts.append(out)
        return cls(mesh, parts, axis)

    @property
    def rows_per_shard(self) -> int:
        return int(self.parts[0][0].shape[self.axis])

    def to_host(self) -> np.ndarray:
        """The whole array on the host (shards of dp row 0)."""
        return torch.cat([s.cpu() for s in self.parts[0]],
                         dim=self.axis).numpy()


def _host_or_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _dp_rows(mesh, n: int) -> int:
    dp = mesh.shape["dp"]
    if n % dp:
        raise ValueError(f"{n} rows do not split over dp = {dp}")
    return n // dp


def chunk_codes(codes: np.ndarray, n_chunks: int, K: int):
    """Split a code array into n_chunks overlapping chunks of C + K codes
    (C = ceil(n_kmers / n_chunks)) plus per-chunk valid k-mer counts, so that
    chunk j produces k-mer positions [j*C, (j+1)*C) of the original sequence.

    Returns (chunks (n_chunks, C+K) uint8, n_valid (n_chunks,) int32).
    """
    n_kmers = max(len(codes) - K, 0)
    C = -(-max(n_kmers, 1) // n_chunks)
    out = np.zeros((n_chunks, C + K), dtype=np.uint8)
    nv = np.zeros(n_chunks, dtype=np.int32)
    for j in range(n_chunks):
        lo = j * C
        hi = min(lo + C + K, len(codes))
        if lo < len(codes):
            out[j, : hi - lo] = codes[lo:hi]
        nv[j] = min(max(n_kmers - lo, 0), C)
    return out, nv


def chunk_packed(words: np.ndarray, n_bases: int, exc: np.ndarray,
                 n_chunks: int, K: int):
    """Split one record's 2-bit packed wire form into n_chunks overlapping
    chunks on word boundaries (the SP split of the packed ingest step).

    Chunk j produces k-mer positions [j*C, (j+1)*C) of the record; C is the
    per-chunk k-mer capacity rounded up to a 16-base word multiple so chunk
    starts stay word-aligned. Exceptions are remapped to chunk-local
    positions (EXC_PAD padding).

    Returns (chunk_words (T, Wc) uint32, n_valid (T,) int32,
             exc_local (T, E) int32).
    """
    n_kmers = max(n_bases - K, 0)
    C = -(-max(n_kmers, 1) // n_chunks)
    C = -(-C // 16) * 16                       # word-aligned chunk starts
    Wc = (C + K + 15) // 16
    out_w = np.zeros((n_chunks, Wc), np.uint32)
    nv = np.zeros(n_chunks, np.int32)
    exc = np.asarray(exc, np.int32)
    loc: list[np.ndarray] = []
    for j in range(n_chunks):
        lo = j * C                             # first base of the chunk
        w0 = lo // 16
        if w0 < len(words):
            span = words[w0:w0 + Wc]
            out_w[j, :len(span)] = span
        nv[j] = min(max(n_kmers - lo, 0), C)
        e = exc[(exc >= lo) & (exc < lo + C + K)] - lo
        loc.append(e)
    E = max(8, 1 << (max((len(e) for e in loc), default=1) - 1).bit_length()) \
        if any(len(e) for e in loc) else 8
    out_e = np.full((n_chunks, E), EXC_PAD, np.int32)
    for j, e in enumerate(loc):
        out_e[j, :len(e)] = e
    return out_w, nv, out_e


def shard_index(index_mat, mesh, axis: int = 0) -> Sharded:
    """Place an index row-sharded over 'tp' and held by every 'dp' row: a
    (G, F) matrix (axis 0) or (P, G, L) bit-planes (axis 1). G must split
    evenly over tp; each shard is its own contiguous tensor."""
    mat = _host_or_tensor(index_mat)
    tp = mesh.shape["tp"]
    G = mat.shape[axis]
    if G % tp:
        raise ValueError(f"{G} index rows do not split over tp = {tp}")
    Gs = G // tp
    return Sharded.from_pieces(
        mesh, [mat.narrow(axis, t * Gs, Gs).contiguous() for t in range(tp)],
        axis=axis)


def _split(mesh, Q: int, T: int) -> tuple[int, int]:
    """(Qs, Ts): rows of a dp slice and chunks of a tp shard."""
    tp = mesh.shape["tp"]
    if T % tp:
        raise ValueError(f"{T} chunks do not split over tp = {tp}")
    return _dp_rows(mesh, Q), T // tp


def _merge_chunks(mesh, sketch_chunks, lF: int,
                  densify: bool) -> list[torch.Tensor]:
    """The SP merge: device (d, t) sketches its chunks of dp slice d
    (``sketch_chunks(d, t, dev) -> (Qs, Ts, F)``), the min over its chunks
    and then over the tp devices (the JAX package's pmin) lands on device
    (d, 0), densified there. Returns the (Qs, F) tables per dp slice."""
    merged = []
    for d, row in enumerate(mesh.devices):
        home = row[0]
        local = [sketch_chunks(d, t, dev).amin(dim=1).to(home)
                 for t, dev in enumerate(row)]
        m = local[0]
        for x in local[1:]:
            m = torch.minimum(m, x)
        merged.append(densify_device(m, lF=lF) if densify else m)
    return merged


def _params_kw(p) -> dict:
    return dict(lF=p.lF, K=p.K, W=p.W, H=p.H, mask_M=p.mask_M,
                max_rem=p.maximal_remainder)


def _code_chunks(mesh, p, fwd, rc, nv):
    """The merge input of a chunked code batch: device (d, t) sketches the
    chunks [t*Ts, (t+1)*Ts) of dp slice d (``_codes_core``, K1 where the
    sort route serves)."""
    fwd, rc, nv = (_host_or_tensor(x) for x in (fwd, rc, nv))
    Q, T, CK = fwd.shape
    Qs, Ts = _split(mesh, Q, T)

    def chunks(d, t, dev):
        sl = (slice(d * Qs, (d + 1) * Qs), slice(t * Ts, (t + 1) * Ts))
        tables = _codes_core(fwd[sl].reshape(-1, CK).to(dev),
                             rc[sl].reshape(-1, CK).to(dev),
                             nv[sl].reshape(-1).to(dev), **_params_kw(p))
        return tables.reshape(Qs, Ts, -1)

    return chunks


def sharded_sketch_batch(p, mesh, densify: bool = True):
    """Returns fn sketching a batch of chunked sequences.

    fn(fwd (Q, T, C+K) u8, rc (Q, T, C+K) u8, n_valid (Q, T) i32) -> (Q, F)
    int32 sketch tables on the mesh's first device (INT32_MAX empty;
    densified if asked). Q splits on 'dp', the chunk axis T on 'tp'."""

    def fn(fwd, rc, nv):
        merged = _merge_chunks(mesh, _code_chunks(mesh, p, fwd, rc, nv),
                               p.lF, densify)
        return torch.cat([m.to(mesh.first) for m in merged])

    return fn


def _assemble(mesh, blocks, Q: int, Gs: int):
    """Count blocks ``blocks[d][t]`` (Q / len(blocks), Gs) into one
    (Q, tp*Gs) int32 tensor on the mesh's first device."""
    tp = mesh.shape["tp"]
    Qs = Q // len(blocks)
    out = torch.empty((Q, tp * Gs), dtype=torch.int32, device=mesh.first)
    for d, row in enumerate(blocks):
        for t, c in enumerate(row):
            out[d * Qs:(d + 1) * Qs, t * Gs:(t + 1) * Gs] = c.to(mesh.first)
    return out


def _eq_counts(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(Q, G) int32 equal-slot counts of q (Q, F) against g (G, F), in
    query blocks that keep the compare within 2^26 slots."""
    out = torch.empty((q.shape[0], g.shape[0]), dtype=torch.int32,
                      device=g.device)
    step = max(1, (1 << 26) // max(1, g.shape[0] * g.shape[1]))
    for lo in range(0, q.shape[0], step):
        out[lo:lo + step] = (q[lo:lo + step, None, :] == g[None]).sum(
            -1, dtype=torch.int32)
    return out


def sharded_count(mesh):
    """Returns fn(q_sk (Q, F), index Sharded (G, F)) -> counts (Q, G):
    queries split on 'dp', index rows on 'tp', a plain compare per shard."""

    def fn(q, index):
        q = _host_or_tensor(q)
        Qs = _dp_rows(mesh, q.shape[0])
        blocks = [[_eq_counts(q[d * Qs:(d + 1) * Qs].to(dev),
                              index.parts[d][t])
                   for t, dev in enumerate(row)]
                  for d, row in enumerate(mesh.devices)]
        return _assemble(mesh, blocks, q.shape[0], index.rows_per_shard)

    return fn


def _shard_planes_counts(qp, xs, lo: int, n: int, dev) -> torch.Tensor:
    """K2 of queries [lo, lo+n) of qp (P, Q, L) against the index shard xs
    on ``dev``, one launch per BLOCK_Q queries."""
    outs = [bcount._bcount_call(
                qp[:, a:min(a + bcount.BLOCK_Q, lo + n)].to(dev).contiguous(),
                xs)
            for a in range(lo, lo + n, bcount.BLOCK_Q)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def sharded_count_planes(mesh):
    """The bit-plane count K2 per index shard: the mesh's query kernel.

    Returns fn(qp (P, Q, L), xp Sharded (P, Gp, L)) -> counts (Q, Gp) with
    the query axis split on 'dp', index rows on 'tp'. Q splits evenly over
    dp (callers pad with never-matching query rows), one K2 launch per
    BLOCK_Q queries of each shard."""

    def fn(qp, xp):
        Qs = _dp_rows(mesh, qp.shape[1])
        blocks = [[_shard_planes_counts(qp, xp.parts[d][t], d * Qs, Qs, dev)
                   for t, dev in enumerate(row)]
                  for d, row in enumerate(mesh.devices)]
        return _assemble(mesh, blocks, qp.shape[1], xp.rows_per_shard)

    return fn


def _shard_topk(c: torch.Tensor, k: int, t: int, min_score: int):
    """Per-shard top-k of counts c (n, Gs): count-descending vals, local
    row ids made global (+ t * Gs), sub-min_score entries masked to
    (0, 0)."""
    vals, idx = torch.topk(c, k, dim=1, largest=True, sorted=True)
    gids = (idx + t * c.shape[1]).to(torch.int32)
    return bcount._mask_topk(vals, gids, min_score)


def sharded_count_planes_topk(mesh, *, cap: int, wrap16: bool = False):
    """Per-shard K2 + per-shard top-k: the mesh's sparse hit path. Each
    'tp' shard counts its index rows, keeps its own top-min(cap, Gs) and
    rewrites local row ids to global gids, so only (count, gid) candidates
    leave the shards, never a dense (Q, G) block.

    Returns fn(qp (P, Q, L), xp Sharded, min_score) -> (vals, gids), each
    (Q, tp*k) int32: shard s owns columns [s*k, (s+1)*k), count-descending
    within its block, sub-threshold entries masked to (0, 0). A row
    overflows shard s iff its column s*k + k - 1 is still >= min_score.
    ``wrap16`` wraps counts mod 2^16 first (the reference's uint16 matrix
    counters)."""

    def fn(qp, xp, min_score):
        Q = qp.shape[1]
        Qs, Gs = _dp_rows(mesh, Q), xp.rows_per_shard
        k = min(cap, Gs)
        vals = [[None] * mesh.shape["tp"] for _ in mesh.devices]
        gids = [[None] * mesh.shape["tp"] for _ in mesh.devices]
        for d, row in enumerate(mesh.devices):
            for t, dev in enumerate(row):
                c = _shard_planes_counts(qp, xp.parts[d][t], d * Qs, Qs, dev)
                if wrap16:
                    c = c & 0xFFFF
                vals[d][t], gids[d][t] = _shard_topk(c, k, t, int(min_score))
        return _assemble(mesh, vals, Q, k), _assemble(mesh, gids, Q, k)

    return fn


def sharded_selfjoin(mesh, *, B: int, cap: int | None):
    """An all-vs-all block under the mesh with no query from the host: the
    query block is the B global index rows [lo, lo+B), copied out of the
    shards that own them (the JAX package's masked gather + psum),
    re-encoded as query planes, counted with one K2 launch per 'tp' shard
    (the dp replicas would compute the same counts), wrapped to uint16,
    and, when ``cap`` is set, per-shard top-k with global gids as
    ``sharded_count_planes_topk``.

    Returns fn(xp Sharded (P, Gp, L), lo, min_score) ->
      cap set:  (vals, gids) each (B, tp*k) int32, k = min(cap, Gs)
      cap None: (B, Gp) int32 wrapped counts (min_score ignored)
    on the mesh's first device. [lo, lo+B) must lie inside [0, Gp): every
    query row must be owned, or a zero-filled plane row would alias
    fingerprint 0."""

    def fn(xp, lo, min_score):
        lo = int(lo)
        shards = xp.parts[0]
        P, Gs, L = shards[0].shape
        if lo < 0 or lo + B > Gs * len(shards):
            raise ValueError(f"self-join rows [{lo}, {lo + B}) outside "
                             f"[0, {Gs * len(shards)})")
        qs = torch.empty((P, B, L), dtype=torch.int32, device=mesh.first)
        for t, xs in enumerate(shards):
            a, b = max(lo, t * Gs), min(lo + B, (t + 1) * Gs)
            if b > a:
                qs[:, a - lo:b - lo] = xs[:, a - t * Gs:b - t * Gs].to(
                    mesh.first)
        # stored planes -> query planes (bcount._planes_as_queries)
        qp = torch.cat([qs[:P - 1] | qs[P - 1:], qs[P - 1:]])
        counts = [bcount._bcount_call(qp.to(xs.device), xs) & 0xFFFF
                  for xs in shards]
        if cap is None:
            return _assemble(mesh, [counts], B, Gs)
        k = min(cap, Gs)
        top = [_shard_topk(c, k, t, int(min_score))
               for t, c in enumerate(counts)]
        return (_assemble(mesh, [[v for v, _ in top]], B, k),
                _assemble(mesh, [[g for _, g in top]], B, k))

    return fn


def sharded_count_packed(mesh):
    """The pair-packed count K3 per index shard.

    Returns fn(qp (Q, F/2) int32, xp Sharded (Gp, F/2)) -> counts (Q, Gp)
    with queries split on 'dp', index rows on 'tp'. Each shard counts its
    dp slice in one launch (more only where the output would pass
    pcount.OUT_BUDGET counts), as the port's single-device route does."""

    def fn(qp, xp):
        qp = _host_or_tensor(qp)
        Qs, Gs = _dp_rows(mesh, qp.shape[0]), xp.rows_per_shard
        blocks = []
        for d, row in enumerate(mesh.devices):
            out = []
            for t, dev in enumerate(row):
                qd = qp[d * Qs:(d + 1) * Qs].to(dev)
                parts = [pcount._count_call(qd[a:b], xp.parts[d][t])
                         for a, b in pcount._launch_ranges(
                             Qs, Gs, pcount.OUT_BUDGET)]
                out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
            blocks.append(out)
        return _assemble(mesh, blocks, qp.shape[0], Gs)

    return fn


def _ingest(mesh, merged, index: Sharded, g0: int):
    """The EP insert and the count of an ingest step: the dp slices'
    tables are gathered (Q, F), each 'tp' shard writes the rows
    [g0, g0+Q) it owns (rows owned by another shard are dropped, never
    wrapped) into a copy of itself, and each dp slice counts against the
    updated shards. Returns (new index, counts (Q, G))."""
    all_sk = torch.cat([m.to(mesh.first) for m in merged])
    Q = all_sk.shape[0]
    Gs = index.rows_per_shard
    pieces = []
    for t, xs in enumerate(index.parts[0]):
        new = xs.clone()
        lpos = g0 + torch.arange(Q, device=mesh.first) - t * Gs
        own = (lpos >= 0) & (lpos < Gs)
        new[lpos[own].to(new.device)] = all_sk[own].to(new.device)
        pieces.append(new)
    new_index = Sharded.from_pieces(mesh, pieces, axis=0)
    blocks = [[_eq_counts(merged[d].to(dev), new_index.parts[d][t])
               for t, dev in enumerate(row)]
              for d, row in enumerate(mesh.devices)]
    return new_index, _assemble(mesh, blocks, Q, Gs)


def make_ingest_step_packed(p, mesh):
    """The fused mesh step on the 2-bit packed wire: SP-chunked sketch
    (K1 per device where lF + Wb <= 30) and the min over the chunks,
    densify on the device, the EP-routed insert into the tp-sharded index,
    and a DP x TP count of the batch against the updated index.

    fn(words (Q,T,Wc) u32, nv (Q,T) i32, exc (Q,T,E) i32, index Sharded
       (G,F), g0) -> (new_index Sharded (G,F), counts (Q,G))
    """

    def step(words, nv, exc, index, g0):
        if not isinstance(words, torch.Tensor):
            words = np.ascontiguousarray(words, np.uint32).view(np.int32)
        words, nv, exc = (_host_or_tensor(x) for x in (words, nv, exc))
        Q, T, Wc = words.shape
        Qs, Ts = _split(mesh, Q, T)

        def chunks(d, t, dev):
            sl = (slice(d * Qs, (d + 1) * Qs), slice(t * Ts, (t + 1) * Ts))
            tables = _batch_core(words[sl].reshape(-1, Wc).to(dev),
                                 nv[sl].reshape(-1).to(dev),
                                 exc[sl].reshape(Qs * Ts, -1).to(dev),
                                 **_params_kw(p))
            return tables.reshape(Qs, Ts, -1)

        return _ingest(mesh, _merge_chunks(mesh, chunks, p.lF, True), index,
                       int(g0))

    return step


def make_ingest_step(p, mesh):
    """The engine's full ingest step on chunked codes: sketch a batch (SP
    over chunks), insert it into the sharded index at rows [g0, g0+Q)
    (EP-style routing to the owning 'tp' shard), and count the batch
    against the updated index (DP x TP).

    fn(fwd (Q,T,C+K), rc, n_valid (Q,T), index Sharded (G,F), g0)
        -> (new_index Sharded (G,F), counts (Q,G))
    """

    def step(fwd, rc, nv, index, g0):
        merged = _merge_chunks(mesh, _code_chunks(mesh, p, fwd, rc, nv),
                               p.lF, True)
        return _ingest(mesh, merged, index, int(g0))

    return step
