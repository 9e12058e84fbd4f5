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
"""

from __future__ import annotations

import os

import torch


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


class Mesh:
    """A (dp, tp) grid of torch devices: ``devices[d][t]`` serves query
    slice d and index shard t. ``shape`` is ``{"dp": dp, "tp": tp}``, as
    the JAX Mesh's."""

    def __init__(self, devices, dp: int, tp: int):
        devices = [torch.device(x) for x in devices]
        if len({x.type for x in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted({x.type for x in devices})}")
        self.devices = [devices[d * tp:(d + 1) * tp] for d in range(dp)]
        self.shape = {"dp": dp, "tp": tp}
        self.size = dp * tp

    @property
    def type(self) -> str:
        """The devices' type, ``cuda`` or ``cpu``."""
        return self.devices[0][0].type

    @property
    def first(self) -> torch.device:
        """Where cross-shard results are assembled: device (0, 0)."""
        return self.devices[0][0]

    def flat(self) -> list[torch.device]:
        """Every device in ('dp', 'tp') order."""
        return [x for row in self.devices for x in row]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"devices={[str(x) for x in self.flat()]})")


def make_mesh(devices=None, dp: int | None = None, tp: int | None = None
              ) -> Mesh:
    """A Mesh over ``devices`` (default: ``device_list("cuda")``), shaped
    (dp, tp) or by default_mesh_shape. Raises where dp * tp differs from
    the number of devices."""
    devices = list(devices) if devices is not None else device_list("cuda")
    n = len(devices)
    if dp is None or tp is None:
        dp, tp = default_mesh_shape(n)
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    return Mesh(devices, dp, tp)
