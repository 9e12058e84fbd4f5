"""Sketch densification on the device, exact in the reference's order.

The counterpart of ``niqki_tpu/ops/densify.py``, as torch code over a batch
of (F,) tables (no Pallas kernel behind it). Densification is
order-sequential and value-dependent: ascending slot scans, each non-empty
slot proposes target hash_family(value, step) % F (keyed on the value), a
fill is visible within the same pass, and ``step`` bumps per pass
(``oracle.densify``, ``native.densify``).

Within a pass the scan stays the reference's, but it needs no loop over the
slots: a probe's target depends only on the value and the step, so a slot
filled during a pass holds a value whose target is that slot itself, and
no fill made in a pass can fill again in it. A pass therefore fills each
empty target with the value of the lowest-numbered slot that probes it,
which is what the sequential scan writes; the native densify rests on the
same argument. Only the low 32 bits of hash_family matter, because F is a
power of two; the port's int64 ``revhash64``/``unrevhash64`` give them.

Termination follows the JAX package and the oracle where the reference
loops forever (a poly-N record's only fingerprint 0 pins every probe,
since revhash64(0) == 0): a pass that fills nothing ends the table when no
value has a probe stride rev % F != 0 (``movable``; fills copy values, so
it never changes), and the 4·F pass cap ends it otherwise. An all-empty
table is returned as it is.
"""

from __future__ import annotations

import torch

from .sketch import INT32_MAX, revhash64, unrevhash64


def densify_device(table: torch.Tensor, *, lF: int) -> torch.Tensor:
    """Densify (F,) or (B, F) int32 tables with the INT32_MAX empty
    sentinel, each on its own; returns new tables of the same shape on the
    same device (still INT32_MAX for what stays empty)."""
    if table.dtype != torch.int32 or table.shape[-1] != 1 << lF:
        raise ValueError(f"expected int32 tables of F = 2^{lF} slots, got "
                         f"{table.dtype} {tuple(table.shape)}")
    one = table.dim() == 1
    t = table.reshape(-1, 1 << lF).clone()
    F = 1 << lF
    mask = F - 1
    dev = t.device
    valid0 = t != INT32_MAX
    v64 = torch.where(valid0, t, 0).to(torch.int64)
    # a value's hashes travel with it: fills copy values, so each slot's
    # (unrevhash, revhash) is copied from its source slot, never recomputed
    unrev, rev = unrevhash64(v64), revhash64(v64)
    movable = (valid0 & ((rev & mask) != 0)).any(dim=1)
    empty = (~valid0).sum(dim=1)
    active = (empty > 0) & (empty < F)
    slots = torch.arange(F, dtype=torch.int64, device=dev).expand_as(v64)
    step = 0
    while bool(active.any()):
        valid = t != INT32_MAX
        tgt = (unrev + step * rev) & mask
        # the lowest-numbered probing slot of each target; empty slots and
        # finished tables probe the spare column F
        tgt = torch.where(valid & active[:, None], tgt, F)
        first = torch.full((t.shape[0], F + 1), F, dtype=torch.int64,
                           device=dev)
        first.scatter_reduce_(1, tgt, slots, reduce="amin")
        first = first[:, :F]
        fill = (~valid) & (first < F)
        src = first.clamp(max=F - 1)
        t = torch.where(fill, torch.gather(t, 1, src), t)
        unrev = torch.where(fill, torch.gather(unrev, 1, src), unrev)
        rev = torch.where(fill, torch.gather(rev, 1, src), rev)
        filled = fill.sum(dim=1)
        empty = empty - filled
        step += 1
        stuck = (filled == 0) & (~movable | (step > 4 * F))
        active = active & (empty > 0) & ~stuck
    return t[0] if one else t
