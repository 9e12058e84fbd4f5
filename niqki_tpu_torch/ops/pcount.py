"""K3: pair-packed fingerprint-match count.

Port of ``niqki_tpu/ops/pcount.py``. ``counts[q, g] = sum_f [Q[q, f] ==
X[g, f]]`` for int16 fingerprints (W <= 14 bits plus the -2 stored and -3
query sentinels) packed two per int32 lane; a half matches iff its 16 bits
of ``x ^ q`` are zero. It serves ``SketchIndex.counts`` where the bit-plane
gate fails (S <= 11) and the index holds G >= 4096 rows.

On the card the count is the hand-written kernel of ``csrc/pcount.cu``; for
CPU tensors the wrapper takes the plain version. Query blocks are padded to
``PC_BLOCK_Q`` rows with -2, as the JAX package pads them; padded query rows
and padded index rows match each other, so results are always sliced to the
real (Q, G).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..hostmem import pad_rows

TILE_G = 128        # index rows are padded to a multiple of this
CHUNK_LANES = 4096  # the JAX kernel's pair lanes per F-chunk (its F gate)
PC_BLOCK_Q = 64     # queries per count dispatch
KERNEL_LANES = 32   # the CUDA kernel's lane chunk: Fp % 32 == 0


def available(F: int) -> bool:
    """The JAX package's shape gate without its TPU check: F/2 pair lanes
    tile exactly into min(4096, F/2)-lane chunks and F % 256 == 0."""
    Fp = F // 2
    return F % 256 == 0 and Fp % min(CHUNK_LANES, Fp) == 0


def pack_rows(a: torch.Tensor) -> torch.Tensor:
    """(N, F) int16 -> (N, F/2) int32, two fingerprints per lane, as a view
    of the same memory (fingerprint 2i in the low half of lane i)."""
    if a.dtype != torch.int16 or a.dim() != 2 or a.shape[1] % 2:
        raise ValueError(f"expected an (N, even F) int16 tensor, got "
                         f"{a.dtype} {tuple(a.shape)}")
    return a.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# the count: kernel K3 and its plain version

def _count_plain(qp: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    Qb = qp.shape[0]
    G, Fp = xp.shape
    out = torch.empty((Qb, G), dtype=torch.int32, device=qp.device)
    step = max(1, (1 << 22) // max(1, G * Fp))
    for lo in range(0, Qb, step):
        z = xp[None] ^ qp[lo:lo + step, None, :]          # (c, G, Fp)
        eq = ((z & 0xFFFF) == 0).to(torch.int32)
        eq += ((z >> 16) & 0xFFFF) == 0    # >> on int32 is arithmetic
        out[lo:lo + step] = eq.sum(dim=2, dtype=torch.int32)
    return out


def _count_call(qp: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """counts (Qb, G) int32 of pair-packed queries qp (Qb, Fp) against the
    pair-packed index xp (G, Fp), both int32 on one device."""
    if qp.dim() != 2 or xp.dim() != 2 or qp.shape[1] != xp.shape[1]:
        raise ValueError(f"pair-packed shapes differ: {tuple(qp.shape)} vs "
                         f"{tuple(xp.shape)}")
    if qp.dtype != torch.int32 or xp.dtype != torch.int32:
        raise ValueError("pair-packed operands must be int32")
    if qp.device != xp.device:
        raise ValueError(f"operands on {qp.device} and {xp.device}")
    if qp.device.type == "cpu":
        return _count_plain(qp, xp)
    kernels.require_cuda(qp, "_count_call")
    if not (qp.is_contiguous() and xp.is_contiguous()):
        raise ValueError("_count_call needs contiguous operands")
    Qb, Fp = qp.shape
    G = xp.shape[0]
    if Fp % KERNEL_LANES or qp.data_ptr() % 16 or xp.data_ptr() % 16:
        raise ValueError(f"_count_call needs Fp % {KERNEL_LANES} == 0 and "
                         "16-byte aligned operands")
    if Qb > 65535 * 64:
        raise ValueError(f"_count_call takes at most {65535 * 64} queries")
    out = torch.empty((Qb, G), dtype=torch.int32, device=qp.device)
    if Qb == 0 or G == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(qp.device):
        err = lib.niqki_pcount(qp.data_ptr(), xp.data_ptr(), out.data_ptr(),
                               Qb, G, Fp, kernels.stream_handle(qp))
    kernels.check(err, "pcount")
    kernels.LAUNCHES["pcount"] += 1
    return out


# ---------------------------------------------------------------------------
# query blocks

def match_counts_packed(q_np: np.ndarray, gp: torch.Tensor, G: int,
                        block_q: int = PC_BLOCK_Q) -> np.ndarray:
    """counts (Q, G) int32 of host int16 queries q_np (Q, F) against the
    pair-packed index gp (Gp, F/2) on its device (Gp a TILE_G multiple,
    padded with -2), one ``block_q`` block per dispatch."""
    Q = q_np.shape[0]
    Qp = -(-Q // block_q) * block_q
    q16 = np.full((Qp, q_np.shape[1]), -2, np.int16)
    q16[:Q] = q_np
    qp = pack_rows(torch.from_numpy(q16).to(gp.device))
    outs = [_count_call(qp[lo:lo + block_q], gp)
            for lo in range(0, Qp, block_q)]
    if not outs:
        return np.zeros((0, G), np.int32)
    return torch.cat(outs)[:Q, :G].cpu().numpy()


def match_counts_pair(q: np.ndarray, g: np.ndarray,
                      block_q: int = PC_BLOCK_Q) -> np.ndarray:
    """counts (Q, G) int32 of int16 queries q (Q, F) against int16 index
    rows g (G, F), on the CPU (the counterpart of the JAX package's
    match_counts_pallas, for tests); the index is padded and packed here."""
    g16 = pad_rows(np.asarray(g, np.int16), TILE_G)
    gp = pack_rows(torch.from_numpy(np.ascontiguousarray(g16)))
    return match_counts_packed(np.asarray(q, np.int16), gp, len(g),
                               block_q=block_q)
