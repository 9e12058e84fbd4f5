"""K2: bit-plane fingerprint-match count, and the index planes around it.

Port of ``niqki_tpu/ops/bcount.py``. The index is stored bit-sliced: plane
p < W holds bit p of every fingerprint, 32 fingerprints per 32-bit lane,
and plane W marks invalid slots. Equality over all W+1 planes is

    match = AND_p XNOR(Q[p], X[p]);   counts[q, g] = sum_lanes popcount(match)

Planes are int32 tensors holding the uint32 bit patterns. Invalid value
planes are all-0 on the stored side (-2) and all-1 on the query side (-3),
so invalid slots match nothing, not even each other.

On the card the count is the hand-written kernel of ``csrc/bcount.cu``,
launched as ``_plan`` lays out; for CPU tensors the wrapper takes the
plain version (XNOR/AND over the planes and a SWAR popcount). Packing,
the query-side re-encoding, top-k and the uint16 wrap are plain torch, as
they are XLA code in the JAX package. Only the int16 query wire is ported;
the split wire served a TPU transport. The host pack of checkpoints
(``np_pack_bitplanes``) is the native library's, with the same bits as the
device pack of the stored side.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import kernels, native
from ..hostmem import big_copy, big_empty, pad_rows

TILE_G = 128        # index rows are padded to a multiple of this
BLOCK_Q = 96        # queries per count dispatch
MATRIX_BLOCK = 8 * BLOCK_Q   # index rows per self-join dispatch

# csrc/bcount.cu's launch geometry: a 96-query x 128-row output tile per
# block, two blocks resident on an SM, shared memory within half an SM's.
KERNEL_TILE_Q = 96
KERNEL_TILE_G = 128
BLOCKS_PER_SM = 2
SMEM_PER_BLOCK = 114_688     # (228 KiB of the SM - 1 KiB per block) / 2
FILL = 0.9                   # least share of the last wave's block slots


def available(F: int, W: int) -> bool:
    """The JAX package's shape gate, kept as is: F % 4096 == 0 and
    1 <= W <= 30 (the CUDA kernel itself needs only F % 256 == 0)."""
    return F % 4096 == 0 and 1 <= W <= 30


# ---------------------------------------------------------------------------
# bit-plane packing

def _to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _pack_bits(b: torch.Tensor) -> torch.Tensor:
    """(N, F) int64 of 0/1 -> (N, F/32) int32: bit f%32 of lane f//32 is the
    value at f. Pairwise combine, never a 32x intermediate."""
    c = b
    w = 1
    while w < 32:
        c = c[:, 0::2] | (c[:, 1::2] << w)
        w *= 2
    return _to_i32_bits(c)


def pack_bitplanes(mat: torch.Tensor, *, W: int, query: bool) -> torch.Tensor:
    """(N, F) int fingerprints -> (W+1, N, F/32) int32 bit-planes on the
    same device. Plane W is 1 where the slot is invalid (outside [0, 2^W));
    invalid value planes are 0 on the stored side, 1 on the query side."""
    m = mat.to(torch.int64)
    valid = (m >= 0) & (m < (1 << W))
    v = torch.where(valid, m, (1 << W) - 1 if query else 0)
    planes = [_pack_bits((v >> p) & 1) for p in range(W)]
    planes.append(_pack_bits((~valid).to(torch.int64)))
    return torch.stack(planes)


def build_index_planes(mat: np.ndarray, W: int, device,
                       row_chunk: int | None = None,
                       sanitized: bool = False) -> torch.Tensor:
    """(G, F) host int matrix -> (W+1, Gp, F/32) int32 planes on ``device``.
    Rows ship and pack in chunks, so the unpacked form on the device stays
    one chunk. ``sanitized=True`` promises values in [-2, 2^W), which makes
    an int16 wire lossless for W <= 14."""
    m = pad_rows(np.asarray(mat), TILE_G)
    if row_chunk is None:
        row_chunk = max(TILE_G, (1 << 26) // m.shape[1])
    if sanitized and W <= 14 and m.dtype != np.int16:
        m = big_copy(m, np.int16)
    chunks = [pack_bitplanes(torch.from_numpy(
                  np.ascontiguousarray(m[lo:lo + row_chunk])).to(device),
                  W=W, query=False)
              for lo in range(0, m.shape[0], row_chunk)]
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)


def np_pack_bitplanes(mat: np.ndarray, W: int,
                      out: np.ndarray | None = None,
                      row_chunk: int = 2048) -> np.ndarray:
    """(N, F) host int fingerprints -> (W+1, N, F/32) uint32 bit-planes on
    the host, the bits of pack_bitplanes(query=False) (checkpoint v3's
    planes files). The native pack writes into ``out`` (a big_empty buffer
    where None; a given out may be a row slice of larger planes, its last
    two axes C-contiguous), ``row_chunk`` rows a call on a thread pool (the
    calls release the GIL). Raises where the native library is not loaded
    or refuses the layout; np_pack_bitplanes_plain is its numpy twin."""
    m = np.ascontiguousarray(mat, np.int32)
    N, F = m.shape
    if F % 32:
        raise ValueError(f"np_pack_bitplanes needs F % 32 == 0, got F={F}")
    if out is None:
        out = big_empty((W + 1, N, F // 32), np.uint32)
    if not native.available():
        raise RuntimeError("np_pack_bitplanes: the native library is not "
                           "loaded")
    if N == 0:
        return out

    def pack(lo: int) -> None:
        hi = min(lo + row_chunk, N)
        if not native.pack_bitplanes(m[lo:hi], W, out[:, lo:hi]):
            raise ValueError(f"np_pack_bitplanes: the native pack refuses "
                             f"W={W} or out {out.dtype} {out.shape} strides "
                             f"{out.strides}")

    chunks = range(0, N, row_chunk)
    if len(chunks) == 1:
        pack(0)
    else:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            list(ex.map(pack, chunks))
    return out


def np_pack_bitplanes_plain(mat: np.ndarray, W: int,
                            out: np.ndarray | None = None,
                            row_chunk: int = 2048) -> np.ndarray:
    """The numpy tree pack with np_pack_bitplanes' bits, in row chunks so
    temporaries stay ~row_chunk*F (the plain version the tests hold the
    native pack against)."""
    m = np.asarray(mat)
    N, F = m.shape
    if out is None:
        out = np.empty((W + 1, N, F // 32), np.uint32)

    def pack_bits(b):
        c = b
        w = 1
        while w < 32:
            c = c[:, 0::2] | (c[:, 1::2] << np.uint32(w))
            w *= 2
        return c

    for lo in range(0, N, row_chunk):
        blk = m[lo:lo + row_chunk].astype(np.int64)
        valid = (blk >= 0) & (blk < (1 << W))
        v = np.where(valid, blk, 0).astype(np.uint32)
        for p in range(W):
            out[p, lo:lo + row_chunk] = pack_bits((v >> np.uint32(p))
                                                  & np.uint32(1))
        out[W, lo:lo + row_chunk] = pack_bits((~valid).astype(np.uint32))
    return out


# ---------------------------------------------------------------------------
# the count: kernel K2 and its plain version

def _popcount32(m: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR on the masked
    64-bit value, so the arithmetic shifts see no sign bit)."""
    v = m.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _bcount_plain(qp: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    P, Qb, L = qp.shape
    G = xp.shape[1]
    out = torch.empty((Qb, G), dtype=torch.int32, device=qp.device)
    step = max(1, (1 << 22) // max(1, G * L))
    for lo in range(0, Qb, step):
        q = qp[:, lo:lo + step, None, :]           # (P, c, 1, L)
        m = ~(xp[0][None] ^ q[0])
        for p in range(1, P):
            m &= ~(xp[p][None] ^ q[p])
        out[lo:lo + step] = _popcount32(m).sum(dim=2, dtype=torch.int32)
    return out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(P: int, Qb: int, G: int, L: int, sms: int = 132) -> dict:
    """Launch plan of csrc/bcount.cu for P planes, Qb queries, G rows and
    L lanes (L % 8 == 0) on a card of ``sms`` SMs.

    ``chunk``: lanes staged per step, 4, or 2 when P > 16, so that the raw
    and the transposed buffer (``smem`` bytes) let two blocks share an SM.
    ``split``: the lane axis is cut into ``split`` ranges of ``lanes`` lanes
    (a multiple of 8; the last range may be shorter), one grid row each,
    added by atomics into a zeroed output. It is the least split whose
    blocks fill at least FILL of the block slots of their last wave, or the
    one that fills the most where none does. ``tiles``: the (query, row)
    output tiles, ``blocks``: tiles x split."""
    chunk = 4 if P <= 16 else 2
    smem = 2 * 4 * P * (KERNEL_TILE_Q + KERNEL_TILE_G) * chunk
    tiles = _cdiv(Qb, KERNEL_TILE_Q) * _cdiv(G, KERNEL_TILE_G)
    slots = BLOCKS_PER_SM * sms

    def fill(split):
        blocks = tiles * split
        return blocks / (_cdiv(blocks, slots) * slots)

    split, lanes = 1, L
    for s in range(2, L // 8 + 1):
        if fill(split) >= FILL:
            break
        cut = 8 * _cdiv(L // 8, s)
        if fill(_cdiv(L, cut)) > fill(split):
            split, lanes = _cdiv(L, cut), cut
    return {"chunk": chunk, "smem": smem, "split": split, "lanes": lanes,
            "tiles": tiles, "blocks": tiles * split}


def _plane_pitch(xp: torch.Tensor) -> int | None:
    """Rows from one plane of xp to the next, when xp is whole (P, G, L)
    planes or a row window of larger planes (rows and lanes dense, planes
    ``pitch`` rows apart); None for any other layout."""
    _, G, L = xp.shape
    if xp.stride(2) != 1 or xp.stride(1) != L or xp.stride(0) % L:
        return None
    pitch = xp.stride(0) // L
    return pitch if pitch >= G else None


def _bcount_call(qp: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """counts (Qb, G) int32 of query planes qp (P, Qb, L) against index
    planes xp (P, G, L), both int32 bit patterns on one device. xp may be a
    row window ``planes[:, lo:lo + G]`` of larger planes: the kernel reads
    it in place, planes a pitch apart; no layout is copied."""
    P, Qb, L = qp.shape
    if xp.dim() != 3 or xp.shape[0] != P or xp.shape[2] != L:
        raise ValueError(f"plane shapes differ: {tuple(qp.shape)} vs "
                         f"{tuple(xp.shape)}")
    if qp.dtype != torch.int32 or xp.dtype != torch.int32:
        raise ValueError("planes must be int32 bit patterns")
    if qp.device != xp.device:
        raise ValueError(f"planes on {qp.device} and {xp.device}")
    if qp.device.type == "cpu":
        return _bcount_plain(qp, xp)
    kernels.require_cuda(qp, "_bcount_call")
    pitch = _plane_pitch(xp)
    if not qp.is_contiguous() or pitch is None:
        raise ValueError("_bcount_call needs contiguous query planes and "
                         "index planes whose rows and lanes are dense")
    if L % 8 or qp.data_ptr() % 16 or xp.data_ptr() % 16:
        raise ValueError("_bcount_call needs L % 8 == 0 and 16-byte "
                         "aligned planes")
    if not 2 <= P <= 31:
        raise ValueError(f"_bcount_call takes 2 <= P <= 31 planes, got {P}")
    G = xp.shape[1]
    if Qb == 0 or G == 0 or L == 0:
        return torch.zeros((Qb, G), dtype=torch.int32, device=qp.device)
    plan = _plan(P, Qb, G, L, torch.cuda.get_device_properties(
        qp.device).multi_processor_count)
    alloc = torch.zeros if plan["split"] > 1 else torch.empty
    out = alloc((Qb, G), dtype=torch.int32, device=qp.device)
    lib = kernels.library()
    with torch.cuda.device(qp.device):
        err = lib.niqki_bcount(qp.data_ptr(), xp.data_ptr(), out.data_ptr(),
                               P, Qb, G, pitch, L, plan["chunk"],
                               plan["lanes"], plan["split"],
                               kernels.stream_handle(qp))
    kernels.check(err, "bcount")
    kernels.LAUNCHES["bcount"] += 1
    return out


# ---------------------------------------------------------------------------
# query blocks

def _pack_count_call(qblk: torch.Tensor, xp: torch.Tensor, *, W: int):
    """Device-side bit-plane pack of a query block + the count."""
    return _bcount_call(pack_bitplanes(qblk, W=W, query=True), xp)


def _mask_topk(vals, idx, min_score):
    """Zero sub-threshold top-k entries: (0, gid 0) pairs are ignored by
    every consumer (min_score >= 1 on this path)."""
    keep = vals >= min_score
    return torch.where(keep, vals, 0), torch.where(keep, idx, 0)


def _topk(c: torch.Tensor, cap: int, min_score: int):
    """Row-wise top-``cap`` (count-descending, so vals[:, -1] is the least
    kept count), masked below min_score; gids as int32."""
    vals, idx = torch.topk(c, cap, dim=1, largest=True, sorted=True)
    return _mask_topk(vals, idx.to(torch.int32), min_score)


def _pack_count_topk(qblk, xp, min_score, *, W: int, cap: int):
    return _topk(_pack_count_call(qblk, xp, W=W), cap, min_score)


def match_counts_planes(q_np: np.ndarray, xp: torch.Tensor, G: int, W: int,
                        sanitized: bool = False, topk: int | None = None,
                        min_score: int = 1):
    """counts (Q, G) int32 of host queries q_np (Q, F) against index planes
    xp (W+1, Gp, F/32), one BLOCK_Q block per dispatch, as numpy.

    Queries ship as int16 (W <= 14) or int32 after sanitizing (values
    outside [0, 2^W) become -3 before any narrowing cast, so none aliases a
    valid fingerprint); ``sanitized=True`` promises that already holds.

    ``topk=cap`` returns (vals, idx) (Q, cap) int32 instead: per row the
    cap largest counts, count-descending, with sub-min_score entries masked
    to (0, 0). Rows whose vals[:, -1] >= min_score may have more survivors
    than cap; the caller re-fetches them dense."""
    dt = np.int16 if W <= 14 else np.int32
    q = np.asarray(q_np)
    if q.dtype not in (np.int16, np.int32, np.int64):
        q = q.astype(np.int64)
    if not sanitized:
        q = np.where((q < 0) | (q >= (1 << W)), q.dtype.type(-3), q)
    q = np.ascontiguousarray(q, dt)
    outs = []
    for lo in range(0, len(q), BLOCK_Q):
        blk = torch.from_numpy(q[lo:lo + BLOCK_Q]).to(xp.device)
        if topk is not None:
            outs.append(_pack_count_topk(blk, xp, min_score, W=W, cap=topk))
        else:
            outs.append(_pack_count_call(blk, xp, W=W)[:, :G])
    if topk is not None:
        if not outs:
            z = np.zeros((0, topk), np.int32)
            return z, z.copy()
        return (torch.cat([o[0] for o in outs]).cpu().numpy(),
                torch.cat([o[1] for o in outs]).cpu().numpy())
    if not outs:
        return np.zeros((0, G), np.int32)
    return torch.cat(outs).cpu().numpy()


# ---------------------------------------------------------------------------
# all-vs-all self-join (matrix mode)

def _planes_as_queries(xp: torch.Tensor, lo: int, B: int) -> torch.Tensor:
    """Stored rows [lo, lo+B) re-encoded as QUERY planes: stored-invalid
    slots have all-0 value planes + sentinel 1, query-invalid needs all-1
    value planes, so value |= sentinel. The queries of the all-vs-all are
    the index itself: no query crosses from the host."""
    P = xp.shape[0]
    qs = xp[:, lo:lo + B]
    return torch.cat([qs[:P - 1] | qs[P - 1:], qs[P - 1:]], dim=0)


def _self_join_counts(xp: torch.Tensor, lo: int, B: int) -> torch.Tensor:
    c = _bcount_call(_planes_as_queries(xp, lo, B), xp)
    return c & 0xFFFF   # the reference's uint16 matrix counters


def _self_join_topk(xp: torch.Tensor, lo: int, min_score: int, *, B: int,
                    cap: int):
    """Counts of index rows [lo, lo+B) against the whole index, wrapped to
    uint16, then the top ``cap`` per row: (vals, gids) (B, cap) int32,
    count-descending, sub-min_score entries masked to (0, 0)."""
    return _topk(_self_join_counts(xp, lo, B), cap, min_score)


def _self_join_dense(xp: torch.Tensor, lo: int, *, B: int) -> torch.Tensor:
    """(B, Gp) int32 wrapped counts (min_score == 0: every cell prints)."""
    return _self_join_counts(xp, lo, B)


# ---------------------------------------------------------------------------
# the symmetric sweep: upper-triangle windows

def extend_planes(xp: torch.Tensor, extra: int) -> torch.Tensor:
    """xp (P, Gp, L) followed by ``extra`` never-matching rows (stored
    invalid: all-0 value planes, all-1 sentinel), in one new tensor: the
    symmetric sweep's quantized windows read past Gp, and a padding row
    counts 0 against every query (masked by min_score >= 1 on that path)."""
    if extra <= 0:
        return xp
    P, Gp, L = xp.shape
    out = torch.empty((P, Gp + extra, L), dtype=xp.dtype, device=xp.device)
    out[:, :Gp] = xp
    out[:P - 1, Gp:] = 0
    out[P - 1, Gp:] = -1
    return out


def _self_join_window_topk(xpe: torch.Tensor, lo: int, min_score: int, *,
                           B: int, w: int, cap: int):
    """One step of the symmetric sweep: counts of rows [lo, lo+B) of the
    extended planes xpe against the upper-triangle column window
    [lo, lo+w*B) only, read in place by K2, wrapped to uint16; then the top
    min(cap, w*B) per row: (vals, gids) int32, count-descending, gids
    global, sub-min_score entries masked to (0, 0). The strictly-lower
    tiles are the host's mirrors (equality counts are symmetric)."""
    qp = _planes_as_queries(xpe, lo, B)
    c = _bcount_call(qp, xpe[:, lo:lo + w * B]) & 0xFFFF
    vals, pos = torch.topk(c, min(cap, w * B), dim=1, largest=True,
                           sorted=True)
    return _mask_topk(vals, (pos + lo).to(torch.int32), min_score)


def _window_dense(xpe: torch.Tensor, lo: int, Gp: int) -> torch.Tensor:
    """(n, Gp) int32 wrapped counts of the extended planes' rows
    [lo, lo+BLOCK_Q) (n of them before the end of xpe) against the index
    columns [0, Gp): the symmetric sweep's re-fetch of overflowed rows."""
    qp = _planes_as_queries(xpe, lo, BLOCK_Q)
    return _bcount_call(qp, xpe[:, :Gp]) & 0xFFFF
