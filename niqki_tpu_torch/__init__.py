"""niqki_tpu_torch — the PyTorch/CUDA port of niqki_tpu.

The same engine on an NVIDIA GPU: sketching is vectorized hashing plus a
per-slot min (the bitonic sort kernel K1, ``csrc/psort.cu``), the index is a
dense (G, F) fingerprint matrix held as W+1 bit-planes on the card, and the
all-vs-all matrix and hit queries count with the bit-plane kernel K2
(``csrc/bcount.cu``). Host code (native reader, densify, formatters, fof
drivers) is reused from ``niqki_tpu`` without its JAX device code; this
package never imports jax. ``native`` is that host library, re-exported so
callers of the port need no module of the JAX package.
"""

import os as _os
import sys as _sys

if "niqki_tpu" not in _sys.modules:
    # niqki_tpu's import points JAX's compile cache under HOME; the port
    # runs no JAX, so it leaves HOME alone.
    _os.environ.setdefault("NIQKI_TPU_NO_COMPILE_CACHE", "1")

from niqki_tpu import native  # noqa: E402
from niqki_tpu.params import SketchParams  # noqa: E402

from . import engine  # noqa: E402
from .index import SketchIndex, default_device, ensure_native  # noqa: E402

__version__ = "0.1.0"
__all__ = ["SketchParams", "SketchIndex", "default_device", "engine",
           "ensure_native", "native"]
