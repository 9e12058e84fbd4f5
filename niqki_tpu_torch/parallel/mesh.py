"""Device mesh of the port: a (dp, tp) grid of torch devices.

The counterpart of ``niqki_tpu/parallel/mesh.py``. Two logical axes:
  * 'dp' - data parallel: query and ingest batches split here;
  * 'tp' - table parallel: the index's genome rows split here, and so do the
           sequence chunks of the sharded sketch (the per-slot min is a
           commutative monoid, so one min over the chunks merges them).

There is no ``shard_map``: the port's sharded functions loop over the grid
in Python and launch each shard's work on its own device. A mesh is built
over the real devices of one type (``cuda:0`` ... ``cuda:k-1``, or the one
``cpu``). ``NIQKI_TPU_VIRTUAL_DEVICES=n`` makes the device list n entries
that cycle over those devices, so a ``2x4`` mesh runs on one card, or on
the CPU in the tests: the counterpart of XLA's
``--xla_force_host_platform_device_count``, which gives the JAX package's
tests eight CPU devices. It is no feature of its own.

Across processes (``serving.init_distributed``, a torch.distributed group)
the mesh is built over ``global_device_list``: every rank's device list,
gathered and ordered by rank, as ``jax.devices()`` orders a multi-process
runtime's. Each entry carries the rank that owns it (``MeshDevice``, the
counterpart of ``jax.Device.process_index``); a rank runs only the shards
of its own entries, and the sharded functions exchange the rest
(``parallel.collective``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import collective


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """(dp, tp) with tp as wide as the split allows: the index is usually
    the big object, so it is sharded as wide as possible by default."""
    if n_devices == 1:
        return 1, 1
    dp = 2 if n_devices % 2 == 0 else 1
    return dp, n_devices // dp


def real_devices(kind: str = "cuda") -> list[torch.device]:
    """The real devices of one type: every card torch sees, or the CPU.
    Raises for ``cuda`` where torch sees no card."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"device type {kind!r}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh of CUDA devices, but torch sees no card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_list(kind: str = "cuda") -> list[torch.device]:
    """The mesh's device list: the real devices of ``kind``, or, under
    NIQKI_TPU_VIRTUAL_DEVICES=n, n entries cycling over them."""
    real = real_devices(kind)
    n = os.environ.get("NIQKI_TPU_VIRTUAL_DEVICES", "").strip()
    if not n:
        return real
    return [real[i % len(real)] for i in range(int(n))]


class MeshDevice(NamedTuple):
    """A device of a multi-process mesh and the rank that owns it."""
    rank: int
    device: torch.device


def gather_devices(local) -> list[MeshDevice]:
    """Every rank's ``local`` device list (one all-gather), ordered by rank,
    then by local index."""
    lists = collective.all_gather_object([str(x) for x in local])
    return [MeshDevice(r, torch.device(x))
            for r, devs in enumerate(lists) for x in devs]


def global_device_list(kind: str = "cuda") -> list[MeshDevice]:
    """The device list of every rank of the process group
    (``device_list(kind)`` on each; NIQKI_TPU_VIRTUAL_DEVICES is each
    rank's own, so two ranks of 4 give 8), ordered by rank. Without a
    group of more than one rank, this process's list."""
    rank, size = collective.world()
    if size == 1:
        return [MeshDevice(rank, x) for x in device_list(kind)]
    return gather_devices(device_list(kind))


class Mesh:
    """A (dp, tp) grid of torch devices: ``devices[d][t]`` serves query
    slice d and index shard t, and ``ranks[d][t]`` is the rank that owns
    it. ``shape`` is ``{"dp": dp, "tp": tp}``, as the JAX Mesh's.

    Entries are ``MeshDevice``s or plain devices; a plain device is this
    process's. A mesh whose entries span several ranks (``multi_process``)
    must span every rank of the group, since its collectives run on the
    default group."""

    def __init__(self, devices, dp: int, tp: int):
        self.rank, n_ranks = collective.world()
        entries = [x if isinstance(x, MeshDevice)
                   else MeshDevice(self.rank, torch.device(x))
                   for x in devices]
        if len({x.device.type for x in entries}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted({x.device.type for x in entries})}")
        self.devices = [[x.device for x in entries[d * tp:(d + 1) * tp]]
                        for d in range(dp)]
        self.ranks = [[x.rank for x in entries[d * tp:(d + 1) * tp]]
                      for d in range(dp)]
        owners = {x.rank for x in entries}
        self.multi_process = len(owners) > 1
        if self.multi_process and owners != set(range(n_ranks)):
            raise ValueError(f"a mesh over ranks {sorted(owners)} of a "
                             f"group of {n_ranks}: it must span all")
        if self.rank not in owners:
            raise ValueError(f"no device of this mesh belongs to rank "
                             f"{self.rank}")
        self.shape = {"dp": dp, "tp": tp}
        self.size = dp * tp

    @property
    def type(self) -> str:
        """The devices' type, ``cuda`` or ``cpu``."""
        return self.devices[0][0].type

    @property
    def first_local(self) -> torch.device:
        """This rank's first device in ('dp', 'tp') order: where its
        copies of cross-shard results are assembled."""
        return next(x for (d, t), x in self.cells() if self.is_local(d, t))

    def owner(self, d: int, t: int) -> int:
        return self.ranks[d][t]

    def is_local(self, d: int, t: int) -> bool:
        return self.ranks[d][t] == self.rank

    def cells(self):
        """((d, t), device) of every entry in ('dp', 'tp') order."""
        return [((d, t), x) for d, row in enumerate(self.devices)
                for t, x in enumerate(row)]

    def local_cells(self):
        """((d, t), device) of this rank's entries."""
        return [(c, x) for c, x in self.cells() if self.is_local(*c)]

    def row_home(self, d: int):
        """This rank's first device of dp row d, or None."""
        return next((x for t, x in enumerate(self.devices[d])
                     if self.is_local(d, t)), None)

    def column_home(self, t: int):
        """This rank's first device of tp column t, or None."""
        return next((row[t] for d, row in enumerate(self.devices)
                     if self.is_local(d, t)), None)

    def flat(self) -> list[torch.device]:
        """Every device in ('dp', 'tp') order."""
        return [x for row in self.devices for x in row]

    def __repr__(self) -> str:
        ranks = f", ranks={[r for row in self.ranks for r in row]}" \
            if self.multi_process else ""
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"devices={[str(x) for x in self.flat()]}{ranks})")


def make_mesh(devices=None, dp: int | None = None, tp: int | None = None
              ) -> Mesh:
    """A Mesh over ``devices`` (default: ``global_device_list("cuda")``,
    this process's cards without a group), shaped (dp, tp) or by
    default_mesh_shape. Raises where dp * tp differs from the number of
    devices."""
    devices = list(devices) if devices is not None \
        else global_device_list("cuda")
    n = len(devices)
    if dp is None or tp is None:
        dp, tp = default_mesh_shape(n)
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    return Mesh(devices, dp, tp)
