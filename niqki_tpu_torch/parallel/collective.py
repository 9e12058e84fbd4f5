"""The collectives of a multi-process mesh, over torch.distributed.

The JAX package leaves these to XLA, which compiles them from the
shardings (``pmin``, ``psum``, ``process_allgather``). The port calls them
itself, from the mesh's sharded functions, through the few helpers here:

  * ``all_reduce_min``  - the tp min over sketch chunks (JAX's ``pmin``);
  * ``exchange``        - every rank gets the tensor of every mesh entry
                          named, which only the entry's owner computed (the
                          count blocks' assembly, the self-join's query rows,
                          the ingest's dp slices, the per-device sketch
                          tables): one all-gather of each rank's entries;
  * ``all_gather_object`` - small host objects (device lists, digests).

Under gloo the payload goes through the host: each helper copies it to a
CPU tensor, runs the collective there and copies the result back to the
device asked for. Under NCCL it stays on the card. A mesh whose devices all
belong to this process calls none of these.

Every rank must call every collective, in the same order, from one thread
at a time: the callers' branches depend only on data every rank holds
alike. ``STATS`` counts the calls, the bytes this rank sent and the host
seconds spent in them (``reset_stats`` sets them to 0).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _staging(device) -> torch.device:
    """Where a payload crosses: the host under gloo, the card under NCCL."""
    return torch.device("cpu") if dist.get_backend() == "gloo" \
        else torch.device(device)


def _count(t0: float, nbytes: int) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    STATS["seconds"] += time.perf_counter() - t0


def all_gather_object(obj) -> list:
    """``obj`` of every rank, in rank order."""
    t0 = time.perf_counter()
    out = [None] * world()[1]
    dist.all_gather_object(out, obj)
    _count(t0, 0)
    return out


def all_reduce_min(x: torch.Tensor) -> torch.Tensor:
    """The elementwise min of ``x`` over every rank, on x's device."""
    t0 = time.perf_counter()
    buf = x.to(_staging(x.device)).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.MIN)
    _count(t0, buf.numel() * buf.element_size())
    return buf.to(x.device)


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= int(s)
    return n


def exchange(mesh, entries, local: dict, shape_of, dtype,
             device) -> list[torch.Tensor]:
    """The tensors of ``entries`` ((d, t) cells of ``mesh``), in their
    order, on ``device`` of every rank. ``local[e]`` is entry e's tensor
    where this rank owns e; ``shape_of(e)`` its shape, which every rank
    can tell. On a mesh of one process, the local tensors moved."""
    entries = list(entries)
    if not mesh.multi_process:
        return [local[e].to(device) for e in entries]
    t0 = time.perf_counter()
    n_ranks = world()[1]
    owned = [[e for e in entries if mesh.owner(*e) == r]
             for r in range(n_ranks)]
    sizes = [sum(_nbytes(shape_of(e), dtype) for e in es) for es in owned]
    stage = _staging(mesh.first_local)
    mine = [local[e].contiguous().reshape(-1).view(torch.uint8).to(stage)
            for e in owned[mesh.rank]]
    # one all-gather of every rank's entries, padded to the largest share
    buf = torch.zeros(max(1, max(sizes)), dtype=torch.uint8, device=stage)
    sent = sum(x.numel() for x in mine)
    if sent != sizes[mesh.rank]:
        raise ValueError(f"exchange: {sent} local bytes, "
                         f"{sizes[mesh.rank]} by the entries' shapes")
    if mine:
        torch.cat(mine, out=buf[:sent])
    outs = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(outs, buf)
    got = {}
    for es, buf in zip(owned, outs):
        off = 0
        for e in es:
            n = _nbytes(shape_of(e), dtype)
            got[e] = buf[off:off + n].view(dtype).reshape(shape_of(e))
            off += n
    out = [got[e].to(device) for e in entries]
    _count(t0, sent)
    return out
