"""niqki_tpu_torch — the PyTorch/CUDA port of niqki_tpu.

The same engine on an NVIDIA GPU: sketching is vectorized hashing plus a
per-slot min (the radix sort kernel K1, ``csrc/psort.cu``), the index is a
dense (G, F) fingerprint matrix held on the card as W+1 bit-planes (counted
by the bit-plane kernel K2, ``csrc/bcount.cu``) or, where the bit-plane
gate fails (S <= 11), as int16 fingerprints packed two per lane (counted by
the pair-packed kernel K3, ``csrc/pcount.cu``). The host side (native
reader, densify, formatters, fof ingest and queries) is the package's own
copy of what it uses from the JAX package's jax-free modules; this package
imports neither jax nor ``niqki_tpu``. It runs on the card unless the
caller asks for the CPU.
"""

from . import engine, native
from .index import SketchIndex
from .params import SketchParams

__version__ = "0.1.0"
__all__ = ["SketchParams", "SketchIndex", "engine", "native"]
