"""Host buffers for matrices of many GB.

The port's counterpart of ``niqki_tpu/hostmem.py``, with only what the port
uses. ``big_empty`` and ``big_zeros`` back a large numpy array with an
anonymous mmap hinted to transparent hugepages: fresh 4 KB pages can
first-touch very slowly on virtualized hosts, and hugepages fault far
faster. Any failure falls back to ``np.empty`` / ``np.zeros``, so results
never depend on it.

``write_direct`` and ``read_direct`` move a checkpoint shard's bytes with
``O_DIRECT`` for the aligned bulk: buffered IO of GB files runs at the
rate the page cache is populated. Where the filesystem refuses O_DIRECT
(tmpfs) or a buffer is not 4096-byte aligned (an array handed over from
torch), they take buffered IO, with the same bytes.
"""

from __future__ import annotations

import ctypes
import mmap
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_MADV_HUGEPAGE = 14
_ALIGN = 4096           # O_DIRECT alignment (logical block, worst case)
_CHUNK = 64 << 20       # bytes per IO syscall

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


# ---------------------------------------------------------------------------
# O_DIRECT file IO

def _flat_bytes(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _is_aligned(arr: np.ndarray) -> bool:
    return arr.ctypes.data % _ALIGN == 0


def write_direct(path: str, arr: np.ndarray) -> None:
    """Write ``arr``'s bytes to ``path``: O_DIRECT for the aligned bulk and
    a buffered write of the unaligned tail; buffered throughout where the
    buffer is unaligned or the filesystem refuses O_DIRECT. Byte-identical
    with ``open(path, 'wb').write``."""
    b = _flat_bytes(arr)
    n = b.nbytes
    bulk = (n // _ALIGN) * _ALIGN
    fd = -1
    if bulk and _is_aligned(b) and hasattr(os, "O_DIRECT"):
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                         | os.O_DIRECT, 0o644)
        except OSError:      # the filesystem refuses O_DIRECT (tmpfs)
            fd = -1
    if fd < 0:
        with open(path, "wb") as f:
            f.write(memoryview(b))
        return
    try:
        mv = memoryview(b)
        for lo in range(0, bulk, _CHUNK):
            want = min(_CHUNK, bulk - lo)
            if os.write(fd, mv[lo:lo + want]) != want:
                raise OSError("short O_DIRECT write")
    except OSError:
        os.close(fd)
        with open(path, "wb") as f:   # start again, buffered
            f.write(memoryview(b))
        return
    os.close(fd)
    if n > bulk:
        with open(path, "r+b") as f:
            f.seek(bulk)
            f.write(memoryview(b[bulk:]))


def _readinto_exact(f, mv) -> None:
    """readinto() until ``mv`` is full; raises at the end of the file, so a
    truncated shard never leaves rows unread (fingerprint 0 is valid)."""
    got, n = 0, len(mv)
    while got < n:
        r = f.readinto(mv[got:])
        if not r:
            raise OSError(f"short read: {got} of {n} bytes")
        got += r


def read_direct(path: str, arr: np.ndarray, offset: int = 0) -> None:
    """Fill the C-contiguous ``arr`` from ``path``'s bytes from ``offset``
    on: O_DIRECT for the aligned bulk, buffered where the buffer or offset
    is unaligned or the filesystem refuses O_DIRECT. Raises OSError where
    the file holds fewer than offset + arr.nbytes bytes."""
    if not arr.flags.c_contiguous:
        raise ValueError("read_direct needs a C-contiguous destination")
    b = arr.reshape(-1).view(np.uint8)
    n = b.nbytes
    bulk = (n // _ALIGN) * _ALIGN
    fd = -1
    if bulk and _is_aligned(b) and offset % _ALIGN == 0 \
            and hasattr(os, "O_DIRECT"):
        try:
            fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            fd = -1
    if fd < 0:
        with open(path, "rb") as f:
            f.seek(offset)
            _readinto_exact(f, memoryview(b))
        return
    try:
        mv = memoryview(b)
        got = 0
        while got < bulk:
            r = os.preadv(fd, [mv[got:min(got + _CHUNK, bulk)]],
                          offset + got)
            if r <= 0:
                raise OSError("short O_DIRECT read")
            got += r
    except OSError:
        os.close(fd)
        with open(path, "rb") as f:   # start again, buffered (raises if
            f.seek(offset)            # the file is short)
            _readinto_exact(f, memoryview(b))
        return
    os.close(fd)
    if n > bulk:
        with open(path, "rb") as f:
            f.seek(offset + bulk)
            _readinto_exact(f, memoryview(b[bulk:]))
