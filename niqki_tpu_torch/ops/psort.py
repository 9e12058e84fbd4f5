"""K1: batched ascending sort of int32 rows of power-of-two length.

Port of ``niqki_tpu/ops/psort.py`` ``sort_i32_pow2_batch``. On the card the
sort is the hand-written bitonic network of ``csrc/psort.cu``; for a CPU
tensor the wrapper takes the plain version, ``torch.sort``. The plain
version also serves as the yardstick the kernel is checked against.
"""

from __future__ import annotations

import torch

from .. import kernels

CHUNK_LOG = 15      # 2^15 int32 = 128 KiB of shared memory per block
MIN_LOG = 10


def sort_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values


def sort_i32_pow2_batch(x: torch.Tensor,
                        chunk_log: int | None = None) -> torch.Tensor:
    """Ascending sort of each row of a (B, N) int32 tensor; N a power of two
    (>= 2^10). Rows sort independently. ``chunk_log`` (<= 15) sets the
    kernel's shared-memory chunk; it does not change the result."""
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
    if not x.is_contiguous():
        raise ValueError("sort_i32_pow2_batch needs a contiguous tensor")
    c = min(m, chunk_log or CHUNK_LOG)
    if not 1 <= c <= CHUNK_LOG:
        raise ValueError(f"chunk_log must be in [1, {CHUNK_LOG}]")
    out = torch.empty_like(x)
    if B == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(x.device):
        err = lib.niqki_psort_i32(x.data_ptr(), out.data_ptr(), B, m, c,
                                  kernels.stream_handle(x))
    kernels.check(err, "psort")
    kernels.LAUNCHES["psort"] += 1
    return out
