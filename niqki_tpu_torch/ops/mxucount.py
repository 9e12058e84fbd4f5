"""Hit counting as a one-hot matrix product (``NIQKI_TPU_COUNT=mxu``).

Port of ``niqki_tpu/ops/mxucount.py``, the JAX package's kept negative
verdict: exact equality of W-bit fingerprints is the one-hot join

    counts[q, g] = sum_f sum_v onehot(Q[q, f])[v] * onehot(X[g, f])[v],

2^W multiply-adds per compared fingerprint, where the bit-plane count K2
spends about one integer operation. It stays routable so the verdict can
be measured on the card beside K2; it is never a default. The JAX package
computes it as an XLA ``dot_general`` with no Pallas kernel, so here it is
torch code: per block of FC slots, one-hot rows of (Qt, FC * 2^W) and
(Gt, FC * 2^W) and one ``torch.matmul``, in bf16 on the card (float32 on
the CPU). A block's product is at most FC = 8, exact in bf16, and is added
into a float32 accumulator (exact below 2^24). One bf16 product over all
of F would round counts above 256.

A value below 0 or at least 2^W has an all-zero one-hot row, so the
sentinels (stored -2, query -3) match nothing on either side.
"""

from __future__ import annotations

import numpy as np
import torch

FC = 8           # fingerprint slots per one-hot block
G_TILE = 2048    # index rows per product
Q_TILE = 96      # query rows per product (bcount.BLOCK_Q)


def _one_hot(x: torch.Tensor, W: int, dtype) -> torch.Tensor:
    """(n, FC) int values -> (n, FC * 2^W) one-hot rows of ``dtype``;
    values outside [0, 2^W) give all-zero rows."""
    V = 1 << W
    n, fc = x.shape
    valid = (x >= 0) & (x < V)
    out = torch.zeros((n, fc, V), dtype=dtype, device=x.device)
    out.scatter_(2, torch.where(valid, x, 0).to(torch.int64).unsqueeze(-1),
                 valid.to(dtype).unsqueeze(-1))
    return out.reshape(n, fc * V)


def _count_tile(q: torch.Tensor, x: torch.Tensor, W: int) -> torch.Tensor:
    """(Qt, F) x (Gt, F) int -> (Qt, Gt) int32 equality counts, one
    one-hot product per FC-slot block, summed in float32."""
    dtype = torch.bfloat16 if q.device.type == "cuda" else torch.float32
    F = q.shape[1]
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, F, FC):
        qoh = _one_hot(q[:, lo:lo + FC], W, dtype)
        xoh = _one_hot(x[:, lo:lo + FC], W, dtype)
        acc += torch.matmul(qoh, xoh.T).float()
    return acc.to(torch.int32)


def match_counts_mxu(q_np: np.ndarray, mat: np.ndarray, W: int,
                     device="cuda") -> np.ndarray:
    """counts (Q, G) int32 of host queries against a host int matrix on
    ``device``, one (Q_TILE, G_TILE) tile per product; the index-side
    one-hots are built anew per tile, as in the JAX package."""
    q = np.atleast_2d(np.asarray(q_np, np.int32))
    g = np.asarray(mat, np.int32)
    Q, F = q.shape
    G = g.shape[0]
    if g.shape[1] != F or F % FC:
        raise ValueError(f"match_counts_mxu: query width {F}, index width "
                         f"{g.shape[1]}; both must be equal multiples of "
                         f"{FC}")
    out = np.empty((Q, G), np.int32)
    for glo in range(0, G, G_TILE):
        xs = torch.from_numpy(np.ascontiguousarray(
            g[glo:glo + G_TILE])).to(device)
        for qlo in range(0, Q, Q_TILE):
            qs = torch.from_numpy(np.ascontiguousarray(
                q[qlo:qlo + Q_TILE])).to(device)
            out[qlo:qlo + Q_TILE, glo:glo + G_TILE] = \
                _count_tile(qs, xs, W).cpu().numpy()
    return out
