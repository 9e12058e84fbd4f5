"""K1: batched ascending sort of int32 rows of power-of-two length.

Port of ``niqki_tpu/ops/psort.py`` ``sort_i32_pow2_batch``. On the card the
sort is the hand-written segmented LSD radix sort of ``csrc/psort.cu``; for
a CPU tensor the wrapper takes the plain version, ``torch.sort``. The plain
version also serves as the yardstick the kernel is checked against.
"""

from __future__ import annotations

import torch

from .. import kernels

MIN_LOG = 10
TILE_LOG = 12       # the kernel's tile: at most 2^12 keys of one row
RADIX = 256         # 8-bit digits, four passes


def sort_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values


def _plan(B: int, N: int):
    """The kernel's tile and workspace for B rows of N keys: (T, scratch
    shape, hist shape). A tile is T = min(N, 2^12) keys of one row; the
    passes ping-pong between the output and a (B, N) scratch buffer, and
    hist holds one count per (row, digit, tile)."""
    T = min(N, 1 << TILE_LOG)
    return T, (B, N), (B, RADIX, N // T)


def sort_i32_pow2_batch(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of each row of a (B, N) int32 tensor; N a power of two
    (>= 2^10). Rows sort independently; ``x`` is left untouched."""
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"expected a (B, N) int32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, N = x.shape
    m = N.bit_length() - 1
    if N != 1 << m or m < MIN_LOG:
        raise ValueError(f"row length must be a power of two >= 2^{MIN_LOG},"
                         f" got {N}")
    if x.device.type == "cpu":
        return sort_plain(x)
    kernels.require_cuda(x, "sort_i32_pow2_batch")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("sort_i32_pow2_batch needs a contiguous, 16-byte "
                         "aligned tensor")
    out = torch.empty_like(x)
    if B == 0:
        return out
    _, scratch_shape, hist_shape = _plan(B, N)
    scratch = torch.empty(scratch_shape, dtype=torch.int32, device=x.device)
    hist = torch.empty(hist_shape, dtype=torch.int32, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        err = lib.niqki_psort_i32(x.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), hist.data_ptr(), B, m,
                                  kernels.stream_handle(x))
    kernels.check(err, "psort")
    kernels.LAUNCHES["psort"] += 1
    return out


def sort_i32_pow2(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D int32 tensor of power-of-two length
    (>= 2^10): one row of sort_i32_pow2_batch."""
    return sort_i32_pow2_batch(x[None, :])[0]
