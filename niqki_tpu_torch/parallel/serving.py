"""Mesh index serving: the engine's multi-device query path.

The counterpart of ``niqki_tpu/parallel/serving.py``. ShardedIndex places a
SketchIndex's index row-sharded over the mesh's 'tp' axis (each device owns
a contiguous genome range) and counts query batches split over 'dp', each
shard with the port's own kernel: K2 on bit-planes where its shape gate
holds, K3 on pair-packed rows for W <= 14, a plain compare for small
indexes. Counts equal the single-device path's by construction (sharding
is a layout choice).

Across processes: call ``init_distributed`` on every rank before building
the mesh, then the same API; the mesh spans the ranks
(``mesh.global_device_list``) and each rank holds and counts only the
shards of its own devices. Every rank passes the same inputs and gets the
whole result, as ``process_allgather(tiled=True)`` gives every JAX
process, and must make the same calls in the same order.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import hostmem
from ..index import SketchIndex, hits_from_counts
from ..ops import bcount, pcount
from ..params import SketchParams
from .collective import all_gather_object
from .mesh import default_mesh_shape, global_device_list, make_mesh
from .sharded import (Sharded, sharded_count, sharded_count_packed,
                      sharded_count_planes, sharded_count_planes_topk,
                      sharded_selfjoin)

KERNELS = ("planes", "packed", "dense")
# queries whose bit-plane pack (int64 on the device) stays within 2^28 bytes
_PACK_BYTES = 1 << 28
BACKENDS = ("nccl", "gloo")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join the torch.distributed group of a multi-process mesh; a no-op
    for ``num_processes`` of None or <= 1, as the JAX package's.
    ``coordinator`` is rank 0's "host:port" (JAX's coordinator address),
    ``process_id`` this rank. ``backend`` is ``nccl`` (the default where
    torch sees a card: one process per card, each seeing its own) or
    ``gloo`` (the default on the CPU; it also carries ranks that share one
    card, through the host). Another backend raises, and a failing one
    is never swapped for the other."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if coordinator is None or process_id is None:
        raise ValueError("init_distributed: a multi-process mesh needs the "
                         "coordinator's host:port and this process's id")
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)


def _default_mesh(kind: str):
    devs = global_device_list(kind)
    dp, tp = default_mesh_shape(len(devs))
    return make_mesh(devs, dp=dp, tp=tp)


def _column_pieces(mesh, make) -> list:
    """``make(t, device)`` for each tp column t on this rank's first device
    of the column; None for columns with no device of this rank."""
    return [None if (home := mesh.column_home(t)) is None else make(t, home)
            for t in range(mesh.shape["tp"])]


class ShardedIndex:
    """A row-sharded, device-resident index for batched mesh queries.

    ``kernel`` forces the per-shard count (planes, packed or dense) where
    its shape gate holds; by default the JAX package's choice is made, with
    its ``interpret`` read as "the mesh is on the CPU": planes where
    F % 4096 == 0 and 1 <= W <= 30, packed for W <= 14 under K3's gate,
    both only for G >= 4096 on a card; dense otherwise."""

    def __init__(self, index: SketchIndex, mesh=None,
                 kernel: str | None = None):
        if mesh is None:
            mesh = _default_mesh(index.device.type)
        mat = index._stored()      # empty slots already map to -2
        self._setup(mesh, index.params, list(index.names), index.G, mat)
        p = self.params
        big = self.G >= 4096 or mesh.type == "cpu"
        planes_ok = bcount.available(p.F, p.W)
        packed_ok = p.W <= 14 and pcount.available(p.F)
        if kernel is None:
            kernel = "planes" if big and planes_ok else \
                "packed" if big and packed_ok else "dense"
        elif kernel not in KERNELS or (kernel == "planes" and not planes_ok) \
                or (kernel == "packed" and not packed_ok):
            raise ValueError(f"kernel {kernel!r} is not one of {KERNELS} "
                             f"or its shape gate fails at F={p.F}, W={p.W}")
        self._kernel = kernel
        tile = {"planes": bcount.TILE_G, "packed": pcount.TILE_G,
                "dense": 1}[kernel]
        row_align = self._tp * tile
        pad_g = -self.G % row_align
        self._Gp = self.G + pad_g
        if pad_g:
            # padding rows of -2 match no fingerprint (valid range
            # [-1, 2^W)); they are sliced off the counts
            padded = hostmem.big_empty((self._Gp, mat.shape[1]), np.int32)
            padded[:self.G] = mat
            padded[self.G:] = -2
            mat = padded
        Gs = self._Gp // self._tp
        if kernel == "planes":
            pieces = _column_pieces(mesh, lambda t, dev: (
                bcount.build_index_planes(mat[t * Gs:(t + 1) * Gs], p.W,
                                          dev, sanitized=True)))
            self._planes = Sharded.from_pieces(mesh, pieces, axis=1)
        elif kernel == "packed":
            pieces = _column_pieces(mesh, lambda t, dev: pcount.pack_rows(
                torch.from_numpy(hostmem.big_copy(
                    mat[t * Gs:(t + 1) * Gs], np.int16))).to(dev))
            self._mat = Sharded.from_pieces(mesh, pieces, axis=0)
        else:
            pieces = _column_pieces(mesh, lambda t, dev: torch.from_numpy(
                np.ascontiguousarray(mat[t * Gs:(t + 1) * Gs])).to(dev))
            self._mat = Sharded.from_pieces(mesh, pieces, axis=0)

    def _setup(self, mesh, params, names, G, mat=None) -> None:
        """The fields every layout has. On a mesh across processes every
        rank must hold the same index: a digest of params, names, G (and
        ``mat``, where given) is all-gathered, and any difference raises
        on every rank."""
        self.mesh = mesh
        self.params = params
        self.names = names
        self.G = G
        self._tp = mesh.shape["tp"]
        self._dp = mesh.shape["dp"]
        if not mesh.multi_process:
            return
        h = hashlib.sha256(json.dumps([repr(params), names, G]).encode())
        if mat is not None:
            h.update(np.ascontiguousarray(mat).data)
        digests = all_gather_object(h.hexdigest())
        if len(set(digests)) != 1:
            raise ValueError(f"the ranks hold different indexes (params, "
                             f"names, G or rows): digests {digests}")

    @classmethod
    def from_checkpoint(cls, directory: str, mesh=None) -> "ShardedIndex":
        """The mesh-direct restart: a ShardedIndex straight from a sharded
        checkpoint (v2/v3), each 'tp' shard's bit-planes built from its own
        row ranges and placed on its devices; no global host matrix is
        assembled. v3 reads its persisted planes (ranged O_DIRECT reads of
        the planes files); v2 reads the needed rows (ranged reads, or one
        inflate per gzip shard) and packs them on the host
        (bcount.np_pack_bitplanes, the device pack's bits). Reads and packs
        run on a thread pool. The default mesh is the card's. Across
        processes a rank reads only the shard files that hold rows of its
        own tp columns (every rank reads the names)."""
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt not in ("niqki_tpu.sharded.v2", "niqki_tpu.sharded.v3"):
            raise ValueError(f"mesh-direct load supports v2/v3, got {fmt} "
                             "(v1: use SketchIndex.load_sharded)")
        pp = manifest["params"]
        params = SketchParams(
            lF=pp["lF"], K=pp["K"], W=pp["W"], H=pp["H"],
            min_fract=pp["min_fract"],
            stale_mask_M=pp.get("stale_mask_M"),
            stale_maximal_remainder=pp.get("stale_maximal_remainder"))
        if not (params.F % 4096 == 0 and 1 <= params.W <= 30):
            raise ValueError("mesh-direct load needs the bit-plane kernel "
                             "shape gate (F%4096==0, 1<=W<=30)")
        G = manifest["genomes"]
        names: list[str] = []
        for sh in manifest["shards"]:
            with open(os.path.join(directory, sh["names"]), "rb") as f:
                blob = f.read().decode()
            names.extend(blob.split("\n") if sh["hi"] > sh["lo"] else [])
        if mesh is None:
            mesh = _default_mesh("cuda")
        self = object.__new__(cls)
        self._setup(mesh, params, names, G)
        self._kernel = "planes"
        W, F = params.W, params.F
        L = F // 32
        Gp = G + (-G % (self._tp * bcount.TILE_G))
        self._Gp = Gp
        Gs = Gp // self._tp
        shards = manifest["shards"]

        def fill_rows(out: np.ndarray, a: int, b: int, tasks: list) -> None:
            """Tasks that fill out (W+1, b-a, L) with the planes of global
            rows [a, b): ranged reads of v3 planes files, or a v2 row block
            read (an inflate for .gz) and packed."""
            for sh in shards:
                s_lo, s_hi = sh["lo"], sh["hi"]
                o_lo, o_hi = max(a, s_lo), min(b, s_hi)
                if o_hi <= o_lo:
                    continue
                if "planes" in sh:
                    path = os.path.join(directory, sh["planes"])
                    rows_s = s_hi - s_lo
                    for pl in range(W + 1):
                        tasks.append((hostmem.read_direct, path,
                                      out[pl, o_lo - a:o_hi - a],
                                      (pl * rows_s + o_lo - s_lo) * L * 4))
                    continue

                def pack_shard(sh=sh, o_lo=o_lo, o_hi=o_hi):
                    path = os.path.join(directory, sh["file"])
                    if sh["file"].endswith(".gz"):
                        with open(path, "rb") as f:  # gzip: no ranged reads
                            raw = zlib.decompress(f.read(), 31)
                        blk = np.frombuffer(raw, np.int32).reshape(-1, F)
                        blk = blk[o_lo - sh["lo"]:o_hi - sh["lo"]]
                    else:
                        blk = np.empty((o_hi - o_lo, F), np.int32)
                        hostmem.read_direct(path, blk,
                                            (o_lo - sh["lo"]) * F * 4)
                    bcount.np_pack_bitplanes(blk, W,
                                             out=out[:, o_lo - a:o_hi - a])
                tasks.append((pack_shard,))

        host, tasks = [None] * self._tp, []
        for t in range(self._tp):
            if mesh.column_home(t) is None:
                continue
            a, b = t * Gs, (t + 1) * Gs
            out = hostmem.big_empty((W + 1, Gs, L), np.uint32)
            real = min(b, G)
            if real > a:
                fill_rows(out, a, real, tasks)
            if b > max(real, a):   # padding rows: stored-invalid planes
                pad = max(real, a) - a
                out[:W, pad:] = 0
                out[W, pad:] = 0xFFFFFFFF
            host[t] = out
        if len(tasks) <= 1:
            for task in tasks:
                task[0](*task[1:])
        else:
            with ThreadPoolExecutor(min(8, max(2, os.cpu_count() or 2))) \
                    as ex:
                list(ex.map(lambda task: task[0](*task[1:]), tasks))
        pieces = _column_pieces(mesh, lambda t, dev: torch.from_numpy(
            host[t].view(np.int32)).to(dev))
        self._planes = Sharded.from_pieces(mesh, pieces, axis=1)
        return self

    @staticmethod
    def _to_host(arr: torch.Tensor) -> np.ndarray:
        """A mesh result on the host. Across processes every rank already
        holds the whole result: the sharded functions' all-gathers are the
        counterpart of the JAX package's process_allgather(tiled=True)."""
        return arr.cpu().numpy()

    def _pad_queries(self, q: np.ndarray, align: int) -> np.ndarray:
        pad_q = -len(q) % align
        if pad_q:
            q = np.vstack([q, np.full((pad_q, q.shape[1]), -3, np.int32)])
        return q

    def _plane_chunks(self, q: np.ndarray):
        """(lo, query planes) of the padded sanitized queries q, packed on
        this rank's first mesh device in chunks of dp * BLOCK_Q multiples whose
        int64 pack stays within _PACK_BYTES."""
        align = self._dp * bcount.BLOCK_Q
        n = max(align, _PACK_BYTES // (8 * q.shape[1]) // align * align)
        for lo in range(0, len(q), n):
            blk = torch.from_numpy(np.ascontiguousarray(q[lo:lo + n]))
            yield lo, bcount.pack_bitplanes(blk.to(self.mesh.first_local),
                                            W=self.params.W, query=True)

    def topk_counts(self, q_sanitized: np.ndarray, cap: int,
                    min_score: int):
        """The sparse mesh hit count: per-shard K2 + per-shard top-``cap``
        with global gids (sharded_count_planes_topk).

        q_sanitized must already be _query_side output (values in
        [-3, 2^W)). Returns (vals, gids, shard_cap) with vals/gids
        (Q, tp*shard_cap) int32, or None where the planes kernel is not
        this index's route or min_score < 1 (callers count dense). A row
        overflowed shard s iff vals[row, s*shard_cap + shard_cap - 1]
        >= min_score."""
        if self._kernel != "planes" or min_score < 1:
            return None
        q = np.atleast_2d(np.asarray(q_sanitized, np.int32))
        Q = len(q)
        q = self._pad_queries(q, self._dp * bcount.BLOCK_Q)
        fn = sharded_count_planes_topk(self.mesh, cap=cap)
        vals, gids = [], []
        for _, qp in self._plane_chunks(q):
            v, g = fn(qp, self._planes, min_score)
            vals.append(self._to_host(v))
            gids.append(self._to_host(g))
        vals, gids = np.concatenate(vals), np.concatenate(gids)
        shard_cap = vals.shape[1] // self._tp
        return vals[:Q], gids[:Q], shard_cap

    def selfjoin_block(self, lo: int, B: int, cap: int | None,
                       min_score: int):
        """All-vs-all block [lo, lo+B) against the whole sharded index with
        no query from the host (sharded_selfjoin). cap set: (vals, gids,
        shard_cap), uint16-wrapped counts, per-shard top-k with global
        gids. cap None: dense (B, Gp) uint16 rows. None where the planes
        kernel is not this index's route. [lo, lo+B) must lie inside
        [0, Gp)."""
        if self._kernel != "planes":
            return None
        if lo < 0 or lo + B > self._Gp:
            raise ValueError(f"self-join block [{lo}, {lo + B}) outside "
                             f"[0, {self._Gp})")
        res = sharded_selfjoin(self.mesh, B=B, cap=cap)(
            self._planes, lo, min_score)
        if cap is None:
            return self._to_host(res).astype(np.uint16)
        vals, gids = self._to_host(res[0]), self._to_host(res[1])
        return vals, gids, vals.shape[1] // self._tp

    def counts(self, q_sketches: np.ndarray) -> np.ndarray:
        """(Q, G) hit counts; Q is padded to the mesh's block multiple with
        never-matching -3 rows."""
        q = np.atleast_2d(np.asarray(q_sketches, np.int32))
        q = np.where((q < 0) | (q >= self.params.fingerprint_range), -3, q)
        Q = len(q)
        q = self._pad_queries(q, self._dp * {
            "packed": pcount.PC_BLOCK_Q, "planes": bcount.BLOCK_Q,
            "dense": 1}[self._kernel])
        if self._kernel == "planes":
            fn = sharded_count_planes(self.mesh)
            out = np.concatenate([self._to_host(fn(qp, self._planes))
                                  for _, qp in self._plane_chunks(q)])
        elif self._kernel == "packed":
            qp = pcount.pack_rows(torch.from_numpy(q.astype(np.int16)))
            out = self._to_host(sharded_count_packed(self.mesh)(
                qp, self._mat))
        else:
            out = self._to_host(sharded_count(self.mesh)(q, self._mat))
        return out[:Q, :self.G]

    def hits(self, q_sketch: np.ndarray):
        return hits_from_counts(self.counts(q_sketch[None, :])[0],
                                self.params.min_score)
