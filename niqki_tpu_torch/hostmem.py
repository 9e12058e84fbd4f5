"""Host buffers for matrices of many GB.

The port's counterpart of ``niqki_tpu/hostmem.py``, with only what the port
uses. ``big_empty`` and ``big_zeros`` back a large numpy array with an
anonymous mmap hinted to transparent hugepages: fresh 4 KB pages can
first-touch very slowly on virtualized hosts, and hugepages fault far
faster. Any failure falls back to ``np.empty`` / ``np.zeros``, so results
never depend on it.
"""

from __future__ import annotations

import ctypes
import mmap
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_MADV_HUGEPAGE = 14

try:
    _libc = ctypes.CDLL("libc.so.6", use_errno=True)
except OSError:          # non-glibc platform: no hugepage hint
    _libc = None


def _mapped(shape, dtype) -> np.ndarray | None:
    """A zero-filled array on a hugepage-hinted anonymous mmap, not yet
    faulted in; None for requests under 2 MB or where mmap fails."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dt = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape \
        else dt.itemsize
    if n < (2 << 20) or _libc is None:
        return None
    try:
        buf = mmap.mmap(-1, n)
    except (OSError, OverflowError, ValueError):
        return None
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    _libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(n), _MADV_HUGEPAGE)
    return np.frombuffer(buf, dt, count=n // dt.itemsize).reshape(shape)


def big_empty(shape, dtype) -> np.ndarray:
    """``np.empty`` for large arrays, on a hugepage-hinted anonymous mmap.
    Requests under 2 MB, and any mmap failure, take ``np.empty``. Buffers
    of 128 MB and more are pre-faulted by a few threads (first-touch
    latency parallelizes across cores)."""
    arr = _mapped(shape, dtype)
    if arr is None:
        return np.empty(shape, dtype)
    n = arr.nbytes
    if n >= (128 << 20):
        flat = arr.reshape(-1).view(np.uint8)
        threads = min(4, os.cpu_count() or 1)
        step = -(-n // threads)

        def touch(lo: int) -> None:
            flat[lo:lo + step:4096] = 0  # one byte per 4K page

        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(touch, range(0, n, step)))
    return arr


def big_zeros(shape, dtype) -> np.ndarray:
    """``np.zeros`` for large arrays, on the same mmap as ``big_empty`` but
    not pre-faulted, so a sparse writer (the dump's 2^(S+W)-word bucket
    stream) touches only the pages it writes."""
    arr = _mapped(shape, dtype)
    return np.zeros(shape, dtype) if arr is None else arr


def big_copy(arr: np.ndarray, dtype=None) -> np.ndarray:
    """``arr.astype(dtype)`` / ``arr.copy()`` into a ``big_empty`` buffer."""
    out = big_empty(arr.shape, dtype or arr.dtype)
    np.copyto(out, arr, casting="unsafe")
    return out


def pad_rows(mat: np.ndarray, tile: int) -> np.ndarray:
    """Pad index rows to a ``tile`` multiple with the never-matching -2."""
    G, F = mat.shape
    Gp = -(-G // tile) * tile
    if Gp == G:
        return mat
    out = big_empty((Gp, F), mat.dtype)
    out[:G] = mat
    out[G:] = -2
    return out
