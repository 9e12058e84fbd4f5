"""K3: pair-packed fingerprint-match count.

Port of ``niqki_tpu/ops/pcount.py``. ``counts[q, g] = sum_f [Q[q, f] ==
X[g, f]]`` for int16 fingerprints (W <= 14 bits plus the -2 stored and -3
query sentinels) packed two per int32 lane; a half matches iff its 16 bits
of ``x ^ q`` are zero. It serves ``SketchIndex.counts`` where the bit-plane
gate fails (S <= 11) and the index holds G >= 4096 rows.

On the card the count is the hand-written kernel of ``csrc/pcount.cu``,
launched as ``_plan`` lays out; for CPU tensors the wrapper takes the plain
version. ``match_counts_packed`` counts a whole call's queries in one
launch, unless the launch's output would pass ``OUT_BUDGET`` counts; the
kernel masks the ragged query and row edges, so nothing is padded.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..hostmem import pad_rows

TILE_G = 128        # index rows are padded to a multiple of this
CHUNK_LANES = 4096  # the JAX kernel's pair lanes per F-chunk (its F gate)
PC_BLOCK_Q = 64     # the JAX package's queries per launch; the port's launch
                    # size is set by OUT_BUDGET, not by this
OUT_BUDGET = 1 << 26   # int32 counts of one launch's output (256 MiB)

# csrc/pcount.cu's launch geometry: a 64-, 96- or 128-query x 128-row
# output tile per block (the one that pads the call least: the 128 tile on
# 64- or 96-query calls is slower on the card), lanes staged in 32-lane
# chunks (rows padded to 36 words) into two buffers, two blocks resident on
# an SM, 16-bit per-half counters.
KERNEL_TILES_Q = (128, 96, 64)
KERNEL_TILE_G = 128
KERNEL_LANES = 32            # Fp % 32 == 0; lane ranges are whole chunks
LANE_CAP = 32768             # lanes a range may hold (16-bit counters)
BLOCKS_PER_SM = 2
FILL = 0.9                   # least share of the last wave's block slots


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(Qb: int, G: int, Fp: int, sms: int = 132) -> dict:
    """Launch plan of csrc/pcount.cu for Qb queries, G rows and Fp pair
    lanes (Fp % 32 == 0) on a card of ``sms`` SMs.

    ``split``: the lane axis is cut into ``split`` ranges of ``lanes`` lanes
    (whole 32-lane chunks, at most LANE_CAP; the last range may be shorter),
    one grid row each, added by atomics into a zeroed output. It is the
    least split within the cap whose blocks fill at least FILL of the block
    slots of their last wave, or the one that fills the most where none
    does. ``tiles``: the (query, row) output tiles, ``blocks``: tiles x
    split, ``smem``: a block's two stage buffers in bytes. ``tile_q``: the
    block's queries, the tile that pads Qb least (the larger on a tie)."""
    tile_q = min(KERNEL_TILES_Q, key=lambda t: (_cdiv(Qb, t) * t, -t))
    tiles = _cdiv(Qb, tile_q) * _cdiv(G, KERNEL_TILE_G)
    slots = BLOCKS_PER_SM * sms
    chunks = Fp // KERNEL_LANES

    def fill(split):
        blocks = tiles * split
        return blocks / (_cdiv(blocks, slots) * slots)

    def ranges(s):       # s ranges of whole chunks, as even as they come
        lanes = KERNEL_LANES * _cdiv(chunks, s)
        return _cdiv(Fp, lanes), lanes

    split, lanes = ranges(_cdiv(Fp, LANE_CAP))
    for s in range(split + 1, chunks + 1):
        if fill(split) >= FILL:
            break
        n, cut = ranges(s)
        if fill(n) > fill(split):
            split, lanes = n, cut
    return {"tile_q": tile_q, "split": split, "lanes": lanes,
            "tiles": tiles, "blocks": tiles * split,
            "smem": 2 * (tile_q + KERNEL_TILE_G) * (KERNEL_LANES + 4) * 4}


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
    if Qb == 0 or G == 0 or Fp == 0:
        return torch.zeros((Qb, G), dtype=torch.int32, device=qp.device)
    plan = _plan(Qb, G, Fp, torch.cuda.get_device_properties(
        qp.device).multi_processor_count)
    alloc = torch.zeros if plan["split"] > 1 else torch.empty
    out = alloc((Qb, G), dtype=torch.int32, device=qp.device)
    lib = kernels.library()
    with torch.cuda.device(qp.device):
        err = lib.niqki_pcount(qp.data_ptr(), xp.data_ptr(), out.data_ptr(),
                               Qb, G, Fp, plan["tile_q"], plan["lanes"],
                               plan["split"], kernels.stream_handle(qp))
    kernels.check(err, "pcount")
    kernels.LAUNCHES["pcount"] += 1
    return out


# ---------------------------------------------------------------------------
# query blocks

def _launch_ranges(Q: int, G: int, budget: int) -> list[tuple[int, int]]:
    """The query ranges [lo, hi) of match_counts_packed's launches: as many
    queries as keep one launch's (n, G) int32 output within ``budget``
    counts, and at least one."""
    step = max(1, budget // max(1, G))
    return [(lo, min(lo + step, Q)) for lo in range(0, Q, step)]


def match_counts_packed(q_np: np.ndarray, gp: torch.Tensor,
                        G: int) -> np.ndarray:
    """counts (Q, G) int32 of host int16 queries q_np (Q, F) against the
    first G rows of the pair-packed index gp (Gp, F/2) on its device. The
    queries ship once; each launch counts one range of ``_launch_ranges``
    (one range per call unless the output passes OUT_BUDGET counts) and its
    counts are copied into one host array."""
    Q = q_np.shape[0]
    out = np.empty((Q, G), np.int32)
    qp = pack_rows(torch.from_numpy(
        np.ascontiguousarray(q_np, np.int16))).to(gp.device)
    xp = gp[:G]
    host = torch.from_numpy(out)
    for lo, hi in _launch_ranges(Q, G, OUT_BUDGET):
        host[lo:hi].copy_(_count_call(qp[lo:hi], xp))
    return out


def match_counts_pair(q: np.ndarray, g: np.ndarray,
                      block_q: int | None = None) -> np.ndarray:
    """counts (Q, G) int32 of int16 queries q (Q, F) against int16 index
    rows g (G, F), on the CPU (the counterpart of the JAX package's
    match_counts_pallas, for tests); the index is padded and packed here.
    ``block_q`` is taken for the JAX signature only: the launch size is
    match_counts_packed's."""
    del block_q
    g16 = pad_rows(np.asarray(g, np.int16), TILE_G)
    gp = pack_rows(torch.from_numpy(np.ascontiguousarray(g16)))
    return match_counts_packed(np.asarray(q, np.int16), gp, len(g))
