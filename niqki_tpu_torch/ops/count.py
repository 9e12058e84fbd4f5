"""Plain blocked equality count of sketches.

Port of ``niqki_tpu/ops/count.py``: with exactly one fingerprint per slot,
the index is a dense (G, F) matrix and a hit count is

    counts[q, g] = sum_i [Q[q, i] == X[g, i]]

Plain torch on the tensors' device (the JAX package's is XLA code, no
Pallas kernel). ``SketchIndex`` takes it for indexes outside both count
kernels' gates and under NIQKI_TPU_COUNT=xla.
"""

from __future__ import annotations

import torch


def match_counts(q_sk: torch.Tensor, g_sk: torch.Tensor) -> torch.Tensor:
    """counts (Q, G) int32 of sketches q_sk (Q, F) against g_sk (G, F), in
    one broadcast compare (for small problems)."""
    return (q_sk[:, None, :] == g_sk[None, :, :]).sum(-1, dtype=torch.int32)


def match_counts_blocked(q_sk: torch.Tensor, g_sk: torch.Tensor,
                         block_q: int = 128) -> torch.Tensor:
    """match_counts in blocks of ``block_q`` queries, so the compare holds
    at most block_q * G * F elements at a time."""
    out = torch.empty((q_sk.shape[0], g_sk.shape[0]), dtype=torch.int32,
                      device=q_sk.device)
    for lo in range(0, q_sk.shape[0], block_q):
        out[lo:lo + block_q] = match_counts(q_sk[lo:lo + block_q], g_sk)
    return out
