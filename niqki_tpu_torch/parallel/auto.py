"""When the engine's surface (SketchIndex, engine, CLI) runs on a mesh.

The counterpart of ``niqki_tpu/parallel/auto.py``:

  NIQKI_TPU_MESH = "auto"   (default) more than one real card of the
                            index's device type -> the default ('dp', 'tp')
                            shape over them; one card or the CPU -> off
                   "DxT"    an explicit shape over the first D*T entries of
                            the device list (``mesh.device_list``; e.g.
                            "2x4" on one card or the CPU under
                            NIQKI_TPU_VIRTUAL_DEVICES=8)
                   "off"    the single-device paths

Virtual devices never switch ``auto`` on, as the JAX package's CPU devices
never do. The CLI exposes the same choice as --mesh. A mesh is cached per
(spec, device list), so the sharded sketch dispatch, ShardedIndex serving
and the ingest step all see one grid object.

Under a torch.distributed group of more than one rank
(``serving.init_distributed``) both ``auto`` and ``DxT`` build over the
devices of every rank (``mesh.gather_devices``, one all-gather when the
cache misses, which it does on every rank alike): ``auto`` over every
rank's real cards, ``DxT`` over the first D*T entries of the global device
list.
"""

from __future__ import annotations

import os

import torch

from . import collective
from .mesh import (default_mesh_shape, device_list, gather_devices,
                   make_mesh, real_devices)

OFF = ("off", "none", "0", "1", "1x1")
_cache: dict = {}


def mesh_spec() -> str:
    return os.environ.get("NIQKI_TPU_MESH", "auto").strip().lower()


def _mesh_over(key, devs, dp=None, tp=None):
    """The cached mesh of ``key`` over ``devs`` (this rank's list; every
    rank's, gathered, under a group of more than one rank)."""
    if key not in _cache:
        if collective.world()[1] > 1:
            devs = gather_devices(devs)
        if dp is None:
            dp, tp = default_mesh_shape(len(devs))
        _cache[key] = make_mesh(devs[:dp * tp], dp=dp, tp=tp)
    return _cache[key]


def active_mesh(device="cuda"):
    """The mesh for an index on ``device`` (its type decides the device
    list), or None for single-device execution. Other specs than auto, off
    and DxT raise; so does a DxT beyond the device list."""
    spec = mesh_spec()
    kind = torch.device(device).type
    if spec in OFF:
        return None
    world = collective.world()
    if spec in ("auto", ""):
        if kind != "cuda" or not torch.cuda.is_available():
            return None
        devs = real_devices(kind)
        if len(devs) * world[1] < 2:
            return None
        return _mesh_over((spec, tuple(devs), world), devs)
    try:
        dp_s, tp_s = spec.split("x")
        dp, tp = int(dp_s), int(tp_s)
    except ValueError as e:
        raise ValueError(
            f"NIQKI_TPU_MESH must be 'auto', 'off' or 'DxT', got {spec!r}"
        ) from e
    devs = device_list(kind)
    return _mesh_over((spec, tuple(devs), world), devs, dp, tp)
