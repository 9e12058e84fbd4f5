"""Device sketching: all k-mer windows hashed at once, then a per-slot min.

Port of ``niqki_tpu/ops/sketch.py`` (with the hash family of
``ops/u32pair.py``). The JAX package computes every 64-bit hash on uint32
pairs because the TPU has no 64-bit integers; torch has them, so the hashes
here run on int64 tensors holding the 64-bit patterns. Multiplication wraps
mod 2^64 as wanted, but ``>>`` on int64 is arithmetic, so every logical
right shift is masked (``_shr``). torch has no uint64 shifts on the CPU.

Per-slot min: for lF + Wb <= 30 the composite keys (slot << Wb) | fp are
sorted per record by kernel K1 (``ops.psort``) and each slot's run head is
read by binary search (``_extract_core``); wider keys take a scatter-min.
The empty sentinel on device is INT32_MAX; the host converts it to -1.

Two entry points: ``dispatch_sketch_packed_batch`` (windows of packed
records, the ingest's) and ``dispatch_sketch`` / ``sketch_codes`` /
``make_sketcher`` (one record's code arrays, a batch of one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..debug import span
from .psort import sort_i32_pow2_batch

INT32_MAX = int(np.iinfo(np.int32).max)
REV_C = 0xD6E8FEB86659FD93        # the reference's hash constants
UNREV_C = 0xCFEE444D8B59A89B
EXC_PAD = INT32_MAX               # exception-list padding, dropped


def padded_size(n: int, minimum: int = 1 << 14) -> int:
    """Record length bucket: next power of two with a floor; beyond 2^20
    the next multiple of 2^20 (within ~6% waste)."""
    n = max(n, minimum)
    if n <= 1 << 20:
        return 1 << (n - 1).bit_length()
    m = 1 << 20
    return (n + m - 1) // m * m


# ---------------------------------------------------------------------------
# 64-bit hash family on int64 bit patterns

def _signed64(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (0 < s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _hash64(x: torch.Tensor, c: int) -> torch.Tensor:
    c = _signed64(c)
    x = (_shr(x, 32) ^ x) * c
    x = (_shr(x, 32) ^ x) * c
    return _shr(x, 32) ^ x


def revhash64(x: torch.Tensor) -> torch.Tensor:
    return _hash64(x, REV_C)


def unrevhash64(x: torch.Tensor) -> torch.Tensor:
    return _hash64(x, UNREV_C)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 bit patterns; clz64(0) == 64. Binary search
    on the top bits."""
    n = torch.zeros_like(x)
    y = x
    for s in (32, 16, 8, 4, 2, 1):
        z = _shr(y, 64 - s) == 0
        n = n + z.to(x.dtype) * s
        y = torch.where(z, y << s, y)
    return n + (_shr(y, 63) == 0).to(x.dtype)


# ---------------------------------------------------------------------------
# keys

def _unpack_codes(words: torch.Tensor, exc_idx: torch.Tensor):
    """2-bit wire -> (eff_fwd, eff_rc) uint8 (B, 16*Pw): forward codes, the
    reverse complement as 3 - code, zeroed at the exception positions.
    words: (B, Pw) int32 bit patterns; exc_idx: (B, E) int32, padding at or
    beyond the row length is dropped."""
    B, Pw = words.shape
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
    codes = ((words[:, :, None] >> shifts) & 3).to(torch.uint8)
    codes = codes.reshape(B, Pw * 16)
    n = codes.shape[1]
    ext = torch.empty((B, n + 1), dtype=torch.uint8, device=words.device)
    ext[:, :n] = 3 - codes
    idx = torch.where(exc_idx < n, exc_idx, n).to(torch.int64)
    ext.scatter_(1, idx, 0)
    return codes, ext[:, :n]


def _kmers(codes: torch.Tensor, K: int, reverse: bool) -> torch.Tensor:
    """(B, n) int64 k-mer values of all n = P - K windows:
    forward sum_j codes[i+j] << 2(K-1-j), reverse sum_j codes[i+j] << 2j."""
    n = codes.shape[1] - K
    c = codes.to(torch.int64)
    out = torch.zeros((codes.shape[0], n), dtype=torch.int64,
                      device=codes.device)
    for j in range(K):
        out |= c[:, j:j + n] << (2 * j if reverse else 2 * (K - 1 - j))
    return out


def _slot_fp_core(eff_fwd, eff_rc, n_kmers, *, lF, K, W, H,
                  mask_M=None, max_rem=None):
    """(slot int64, fp int32), each (B, P - K); positions at or beyond a
    row's n_kmers get fp = INT32_MAX. The fingerprint combines the
    saturated exponent with the mantissa by ADDITION, which the -G stale
    constants need (they can overlap)."""
    M = W - H
    maximal_remainder = (1 << H) - 1 if max_rem is None else max_rem
    mask_M = (1 << M) - 1 if mask_M is None else mask_M
    canon = torch.minimum(_kmers(eff_fwd, K, False), _kmers(eff_rc, K, True))
    h = revhash64(canon)
    slot = _shr(unrevhash64(canon), 64 - lF)
    rem = torch.clamp(maximal_remainder - clz64(h), min=0)
    fp = ((rem << M) + (h & mask_M)).to(torch.int32)
    pos = torch.arange(fp.shape[1], device=fp.device)
    return slot, torch.where(pos[None, :] < n_kmers[:, None], fp, INT32_MAX)


def _fp_bits(W, H, mask_M, max_rem):
    """Bits needed for any fingerprint value: W, or wider when the -G stale
    constants push (max_rem << M) + mask_M past 2^W."""
    M = W - H
    mr = (1 << H) - 1 if max_rem is None else max_rem
    mm = (1 << M) - 1 if mask_M is None else mask_M
    return max(W, ((mr << M) + mm).bit_length())


def _keys_core(eff_fwd, eff_rc, n_kmers, *, lF, K, W, H,
               mask_M=None, max_rem=None):
    """(B, P - K) int32 sort keys (slot << Wb) | fp, INT32_MAX at padding.
    Needs lF + Wb <= 30, so no real key aliases the padding."""
    Wb = _fp_bits(W, H, mask_M, max_rem)
    slot, fp = _slot_fp_core(eff_fwd, eff_rc, n_kmers, lF=lF, K=K, W=W, H=H,
                             mask_M=mask_M, max_rem=max_rem)
    key = ((slot << Wb) | fp.to(torch.int64)).to(torch.int32)
    return torch.where(fp == INT32_MAX, INT32_MAX, key)


def _extract_core(sk: torch.Tensor, *, lF: int, Wb: int) -> torch.Tensor:
    """(B, F) per-slot min fingerprints from row-wise ascending keys: each
    slot's run head is its minimum, found by binary search."""
    B, N = sk.shape
    F = 1 << lF
    slots = torch.arange(F, dtype=torch.int32, device=sk.device)
    targets = (slots << Wb).expand(B, F).contiguous()
    starts = torch.searchsorted(sk, targets).clamp_(max=N - 1)
    v = torch.gather(sk, 1, starts)
    hit = ((v >> Wb) == slots) & (v != INT32_MAX)
    return torch.where(hit, v & ((1 << Wb) - 1), INT32_MAX)


def _i16_table(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == INT32_MAX, -1, t).to(torch.int16)


def _codes_core(codes, eff_rc, n_kmers, *, lF, K, W, H,
                mask_M=None, max_rem=None, to_i16=False):
    """(B, F) sketch tables of a batch of 2-bit code rows (eff_fwd,
    eff_rc) (B, P) uint8 with n_kmers (B,) valid windows each (INT32_MAX
    empty, or int16 with -1 empty when ``to_i16``). The sort route (K1)
    serves lF + Wb <= 30; wider keys take the scatter-min."""
    Wb = _fp_bits(W, H, mask_M, max_rem)
    if lF + Wb <= 30:
        keys = _keys_core(codes, eff_rc, n_kmers, lF=lF, K=K, W=W, H=H,
                          mask_M=mask_M, max_rem=max_rem)
        n = keys.shape[1]
        Np = max(1 << (n - 1).bit_length(), 1 << 10)
        keys = torch.nn.functional.pad(keys, (0, Np - n), value=INT32_MAX)
        out = _extract_core(sort_i32_pow2_batch(keys), lF=lF, Wb=Wb)
    else:
        slot, fp = _slot_fp_core(codes, eff_rc, n_kmers, lF=lF, K=K, W=W,
                                 H=H, mask_M=mask_M, max_rem=max_rem)
        out = torch.full((codes.shape[0], 1 << lF), INT32_MAX,
                         dtype=torch.int32, device=codes.device)
        out.scatter_reduce_(1, slot, fp, reduce="amin")
    return _i16_table(out) if to_i16 else out


def _batch_core(words, n_kmers, exc_idx, *, lF, K, W, H,
                mask_M=None, max_rem=None, to_i16=False):
    """(B, F) sketch tables of a batch of packed records (``_codes_core``
    after unpacking the 2-bit wire)."""
    codes, eff_rc = _unpack_codes(words, exc_idx)
    return _codes_core(codes, eff_rc, n_kmers, lF=lF, K=K, W=W, H=H,
                       mask_M=mask_M, max_rem=max_rem, to_i16=to_i16)


# ---------------------------------------------------------------------------
# host-facing batching

def pack_codes(eff_fwd: np.ndarray, eff_rc: np.ndarray, K: int):
    """Python fallback for the native packed reader: (words, n, exc_idx)."""
    n = len(eff_fwd)
    nw = (n + 15) // 16
    c = np.zeros(nw * 16, np.uint32)
    c[:n] = eff_fwd
    c = c.reshape(nw, 16)
    words = np.zeros(nw, np.uint32)
    for j in range(16):
        words |= c[:, j] << np.uint32(2 * j)
    body = slice(K - 1, n)
    exc = np.nonzero(eff_rc[body] != (3 - eff_fwd[body]))[0].astype(np.int32)
    return words, n, exc + np.int32(K - 1)


def _param_kw(p) -> dict:
    return dict(lF=p.lF, K=p.K, W=p.W, H=p.H, mask_M=p.mask_M,
                max_rem=p.maximal_remainder)


def _mesh_batch(mesh, w, nk, ex, device, **kw):
    """_batch_core with the record rows split over every mesh device in
    ('dp', 'tp') order, one launch set per device (K1 on each where the
    sort route serves); the tables are concatenated in device order on
    ``device``. The rows divide evenly (the caller pads them). On a mesh
    across processes each rank sketches the rows of its own devices, and
    the tables are all-gathered in device order."""
    from ..parallel.collective import exchange
    n = len(w) // mesh.size
    cells = [c for c, _ in mesh.cells()]
    local = {}
    for i, (c, dev) in enumerate(mesh.cells()):
        if mesh.is_local(*c):
            local[c] = _batch_core(
                torch.from_numpy(w[i * n:(i + 1) * n]).to(dev),
                torch.from_numpy(nk[i * n:(i + 1) * n]).to(dev),
                torch.from_numpy(ex[i * n:(i + 1) * n]).to(dev), **kw)
    F = 1 << kw["lF"]
    dtype = torch.int16 if kw["to_i16"] else torch.int32
    return torch.cat(exchange(mesh, cells, local, lambda c: (n, F), dtype,
                              device))


def dispatch_sketch_packed_batch(records, p, device,
                                 max_elems: int = 1 << 27,
                                 min_pad: int = 1 << 14):
    """Sketch a window of packed records (words, n_bases, exc_idx) on
    ``device``. Records are grouped by padded length, stacked into one
    (B, Pw) batch per group (at most ``max_elems`` bases), shipped at 2 bits
    per base and sketched together. Returns [(record_indices, (Bp, F)
    tensor)]; rows beyond len(record_indices) are padding, and records with
    no k-mers are left out. Kernels launch asynchronously on a CUDA device.

    The row count is padded up to the {2^k, 3*2^(k-1)} grid, which caps
    padded-row waste at 33% and keeps the set of batch shapes small. Under
    an active mesh (``parallel.auto.active_mesh(device)``) each batch is
    split over every mesh device (rows padded to 2 x the device count) and
    the tables come back on ``device`` in row order."""
    with span("k1.dispatch", 2) as sp:
        out = _dispatch_packed(records, p, device, max_elems, min_pad)
        if sp:
            sp.set(batches=len(out),
                   rows=sum(int(d.shape[0]) for _, d in out))
    return out


def _dispatch_packed(records, p, device, max_elems: int, min_pad: int):
    from ..parallel.auto import active_mesh
    groups: dict[int, list[int]] = {}
    for i, (_, n, _e) in enumerate(records):
        if n - p.K > 0:
            groups.setdefault(padded_size(n, min_pad), []).append(i)
    out = []
    to16 = _fp_bits(p.W, p.H, p.mask_M, p.maximal_remainder) <= 14
    mesh = active_mesh(device)
    row_align = 2 if mesh is None else 2 * mesh.size
    kw = dict(_param_kw(p), to_i16=to16)
    for P, idxs in sorted(groups.items()):
        maxb = max(1, (max_elems // 4) // P)
        for lo in range(0, len(idxs), maxb):
            chunk = idxs[lo:lo + maxb]
            B = len(chunk)
            Bp = 1 << (B - 1).bit_length()
            if B <= Bp // 4 * 3:
                Bp = Bp // 4 * 3
            Bp = -(-Bp // row_align) * row_align
            Pw = P // 16
            emax = max(len(records[i][2]) for i in chunk)
            E = max(8, 1 << (max(emax, 1) - 1).bit_length())
            w = np.zeros((Bp, Pw), np.uint32)
            nk = np.zeros((Bp,), np.int32)
            ex = np.full((Bp, E), EXC_PAD, np.int32)
            for row, i in enumerate(chunk):
                words, n, exc = records[i]
                w[row, :len(words)] = words
                nk[row] = n - p.K
                ex[row, :len(exc)] = exc
            if mesh is not None:
                dev = _mesh_batch(mesh, w.view(np.int32), nk, ex, device,
                                  **kw)
            else:
                dev = _batch_core(
                    torch.from_numpy(w.view(np.int32)).to(device),
                    torch.from_numpy(nk).to(device),
                    torch.from_numpy(ex).to(device), **kw)
            out.append((chunk, dev))
    return out


# ---------------------------------------------------------------------------
# one record's code arrays

def dispatch_sketch(eff_fwd: np.ndarray, eff_rc: np.ndarray, p,
                    device="cuda"):
    """One record's (F,) int32 sketch table (INT32_MAX empty, before
    densify) as a tensor on ``device``, launched without a sync; None for a
    record with no k-mers (length <= K). The codes are padded to
    ``padded_size(n)`` and sketched as a batch of one; ``eff_rc`` is taken
    as given (the caller zeroes its exceptions)."""
    n = len(eff_fwd)
    n_kmers = n - p.K
    if n_kmers <= 0:
        return None
    codes = np.zeros((2, padded_size(n)), np.uint8)
    codes[0, :n] = eff_fwd
    codes[1, :n] = eff_rc
    dev = torch.from_numpy(codes).to(device)
    nk = torch.full((1,), n_kmers, dtype=torch.int32, device=dev.device)
    return _codes_core(dev[0:1], dev[1:2], nk, **_param_kw(p))[0]


def sketch_codes(eff_fwd: np.ndarray, eff_rc: np.ndarray, p,
                 device="cuda") -> np.ndarray:
    """One record's sketch table on ``device``, synchronously: an (F,)
    int32 numpy array of per-slot min fingerprints, INT32_MAX where a slot
    is empty (not densified)."""
    out = dispatch_sketch(eff_fwd, eff_rc, p, device)
    if out is None:
        return np.full(p.F, INT32_MAX, np.int32)
    return out.cpu().numpy()


def make_sketcher(p, device="cuda"):
    """fn(eff_fwd, eff_rc, n_kmers) -> (F,) int32 sketch table on
    ``device``, closed over the params: 1-D uint8 code tensors (padded by
    the caller) with n_kmers valid windows."""
    kw = _param_kw(p)

    def fn(eff_fwd, eff_rc, n_kmers):
        f = torch.as_tensor(eff_fwd, device=device)[None]
        r = torch.as_tensor(eff_rc, device=device)[None]
        nk = torch.as_tensor(n_kmers, dtype=torch.int32,
                             device=f.device).reshape(1)
        return _codes_core(f, r, nk, **kw)[0]
    return fn
