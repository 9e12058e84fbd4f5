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
"""

from __future__ import annotations

import os

import torch

from .mesh import default_mesh_shape, device_list, make_mesh, real_devices

OFF = ("off", "none", "0", "1", "1x1")
_cache: dict = {}


def mesh_spec() -> str:
    return os.environ.get("NIQKI_TPU_MESH", "auto").strip().lower()


def active_mesh(device="cuda"):
    """The mesh for an index on ``device`` (its type decides the device
    list), or None for single-device execution. Other specs than auto, off
    and DxT raise; so does a DxT beyond the device list."""
    spec = mesh_spec()
    kind = torch.device(device).type
    if spec in OFF:
        return None
    if spec in ("auto", ""):
        if kind != "cuda" or not torch.cuda.is_available() \
                or torch.cuda.device_count() < 2:
            return None
        devs = real_devices(kind)
        key = (spec, tuple(devs))
        if key not in _cache:
            dp, tp = default_mesh_shape(len(devs))
            _cache[key] = make_mesh(devs, dp=dp, tp=tp)
        return _cache[key]
    try:
        dp_s, tp_s = spec.split("x")
        dp, tp = int(dp_s), int(tp_s)
    except ValueError as e:
        raise ValueError(
            f"NIQKI_TPU_MESH must be 'auto', 'off' or 'DxT', got {spec!r}"
        ) from e
    devs = device_list(kind)
    key = (spec, tuple(devs))
    if key not in _cache:
        _cache[key] = make_mesh(devs[:dp * tp], dp=dp, tp=tp)
    return _cache[key]
