"""Entry points of the port: a one-device query step and the mesh dry run.

The counterparts of ``__graft_entry__.entry`` and
``__graft_entry__.dryrun_multichip``. Both run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import gzip
import os
import tempfile

import numpy as np
import torch

from . import engine, native, oracle
from .index import SketchIndex
from .io.writers import GzTextWriter
from .ops.densify import densify_device
from .ops.sketch import EXC_PAD, INT32_MAX, _batch_core, pack_codes
from .params import SketchParams
from .parallel.auto import active_mesh
from .parallel.mesh import default_mesh_shape, device_list, make_mesh
from .parallel.serving import ShardedIndex
from .parallel.sharded import (chunk_packed, make_ingest_step_packed,
                               shard_index)


def entry(device="cuda"):
    """(fn, example_args): the query step on the engine's wire format,
    2-bit packed words (+ reverse-complement exceptions) -> unpack -> hash
    -> per-slot-min sketch (K1 on the card) -> densify_device -> counts
    against an index, on one device."""
    p = SketchParams(lF=10, K=31, W=12, H=4)
    G, P, E = 128, 1 << 14, 16

    def query_step(words, n_kmers, exc_idx, index_mat):
        table = _batch_core(words[None], n_kmers.reshape(1), exc_idx[None],
                            lF=p.lF, K=p.K, W=p.W, H=p.H, mask_M=p.mask_M,
                            max_rem=p.maximal_remainder)
        table = densify_device(table, lF=p.lF)
        return (table[:, None, :] == index_mat[None]).sum(
            -1, dtype=torch.int32)[0]

    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, P // 16, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    args = (torch.from_numpy(words),
            torch.tensor(P - p.K - 7, dtype=torch.int32),
            torch.from_numpy(np.full(E, EXC_PAD, np.int32)),
            torch.from_numpy(rng.integers(0, p.fingerprint_range,
                                          (G, p.F)).astype(np.int32)))
    return query_step, tuple(a.to(device) for a in args)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The mesh path over an n_devices mesh at tiny shapes, checked against
    the oracle (sharding is a layout choice): (a) the product surface, an
    ingest under the mesh (the sharded sketch dispatch), counts through
    the tp-sharded ShardedIndex on the bit-plane route and mesh sparse hits
    equal to the dense hits; (b) the fused packed-wire ingest step (chunked
    sketch + min, routed insert, DP x TP count); (c) the mesh -M: the
    matrix bytes of the mesh's self-join equal the single-device bytes.

    The mesh is the first n_devices entries of the device list of
    ``device``'s type (``parallel.mesh.device_list``; one card takes
    NIQKI_TPU_VIRTUAL_DEVICES). (a)'s index is far below the G >= 4096 of
    the route gate on a card, so its planes route is asked for."""
    kind = torch.device(device).type
    dp, tp = default_mesh_shape(n_devices)
    # lF=12 (F=4096) passes the bit-plane gate F % 4096, so the counts run
    # K2 per shard and the sparse top-k path
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    Q, L, T, G = 2 * dp, 600, tp, 4 * tp
    rng = np.random.default_rng(0)
    seqs = [bytes(rng.choice(list(b"ACGT"), L)) for _ in range(Q)]
    want = np.stack([oracle.sketch_records([s], p) for s in seqs])

    def matrix_bytes(idx) -> bytes:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "m.gz")
            with GzTextWriter(path) as out:
                engine.query_matrix(idx, out)
            with gzip.open(path, "rb") as f:
                return f.read()

    saved = {k: os.environ.get(k) for k in ("NIQKI_TPU_MESH",
                                            "NIQKI_TPU_MATRIX")}
    try:
        # --- (a) the product surface: engine ingest + counts on the mesh
        os.environ["NIQKI_TPU_MESH"] = f"{dp}x{tp}"
        with tempfile.TemporaryDirectory() as td:
            for i, s in enumerate(seqs):
                with open(os.path.join(td, f"g{i}.fa"), "w") as f:
                    f.write(f">g{i}\n{s.decode()}\n")
            with open(os.path.join(td, "fof.txt"), "w") as f:
                f.write("\n".join(f"g{i}.fa" for i in range(Q)) + "\n")
            idx = SketchIndex(p, device=device)
            engine.insert_fof_whole(idx, os.path.join(td, "fof.txt"))
        if not np.array_equal(idx.matrix(), want):
            raise AssertionError("product sketch != oracle")
        mesh = active_mesh(device)
        idx._sharded = ShardedIndex(idx, mesh, kernel="planes")
        counts = idx.counts(idx.matrix())     # routes through ShardedIndex
        if idx._sharded is None or idx._sharded._kernel != "planes":
            raise AssertionError("the mesh planes count route was not taken")
        want_counts = (want[:, None, :] == want[None, :, :]).sum(-1)
        if not np.array_equal(counts, want_counts):
            raise AssertionError("product counts != oracle")
        headers = [f"q{i}" for i in range(Q)]
        buf = idx.pretty_hits_batch(idx.matrix(), headers)
        if buf is None:
            raise AssertionError("mesh sparse top-k path not taken")
        want_buf = native.HitsFormatter(idx.names, p.F, p.min_score).format(
            np.asarray(counts, np.int32), headers)
        if buf != want_buf:
            raise AssertionError("mesh sparse hits != dense hits")

        # --- (c) the mesh -M: its self-join's bytes == one device's
        os.environ["NIQKI_TPU_MATRIX"] = "selfjoin"
        got_m = matrix_bytes(idx)
        os.environ["NIQKI_TPU_MESH"] = "off"
        one = SketchIndex.from_arrays(p, idx.names, idx.matrix(),
                                      device=device)
        if got_m != matrix_bytes(one):
            raise AssertionError("mesh -M bytes != single-device bytes")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # --- (b) the fused packed-wire ingest step
    mesh = make_mesh(device_list(kind)[:n_devices], dp=dp, tp=tp)
    ws, nvs, es = [], [], []
    for s in seqs:
        ef, er = oracle.encode_record(s, p.K)
        words, n, exc = pack_codes(ef, er, p.K)
        cw, nv, ce = chunk_packed(words, n, exc, T, p.K)
        ws.append(cw)
        nvs.append(nv)
        es.append(ce)
    E = max(e.shape[1] for e in es)
    epad = np.full((Q, T, E), EXC_PAD, np.int32)
    for i, e in enumerate(es):
        epad[i, :, :e.shape[1]] = e
    step = make_ingest_step_packed(p, mesh)
    index = shard_index(np.full((G, p.F), -2, np.int32), mesh)
    index, counts = step(np.stack(ws), np.stack(nvs).astype(np.int32),
                         epad, index, 0)
    index = index.to_host()
    want_dev = np.where(want == -1, INT32_MAX, want)
    if not np.array_equal(index[:Q], want_dev):
        raise AssertionError("packed ingest != oracle")
    want_counts = (want_dev[:, None, :] == index[None, :, :]).sum(-1)
    if not np.array_equal(counts.cpu().numpy(), want_counts):
        raise AssertionError("packed ingest counts != oracle")
    print(f"dryrun_multichip OK: mesh=({dp}x{tp}), Q={Q}, G={G}, F={p.F} "
          f"(product surface + packed ingest step + mesh -M)")
