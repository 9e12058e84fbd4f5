"""Plain PyTorch reference of NIQKI's sketches, counts and text rows.

Written from the published algorithm (NIQKI's README and source, as the
JAX package's ``oracle`` documents it), not from the code under test; it
imports torch and numpy only. It serves the benchmark's check of
``correct`` and runs after the measured window, on the device the run uses
or on the CPU, in blocks so that it fits.

Per record: the 2-bit rolling k-mers of a sequence of L bases (the last
k-mer is never consumed, so L - K of them), canonical min of forward and
reverse complement, the slot from the top lF bits of unrevhash64, the
HyperMinHash fingerprint of revhash64 (H bits of leading-zero remainder
over M = W - H mantissa bits), the per-slot minimum, then
one-permutation-hashing densification: repeated ascending passes in which
every filled slot proposes the target hash_family(value, pass) mod F and
fills it if empty, a slot filled earlier in the pass proposing too. A slot
filled in a pass holds its filler's value, whose target is that slot
itself, so it fills nothing more in that pass; a pass is therefore exactly
"each empty slot takes the value of the lowest-indexed slot, filled when
the pass began, that targets it".

Bases are 2-bit codes: from text, ``encode`` applies NIQKI's rules (the
rolling codes read uppercase A, C, G, T and take 0 for anything else, on
both strands; the first K - 1 bases are read case-blind, and any other
letter among them zeroes them all); the generator writes only ACGT, whose
codes are A=0, C=1, G=2, T=3 and 3 - code on the other strand.

Counts are the number of slots with equal fingerprints, where fingerprints
outside [0, 2^W) match nothing; a matrix counter is a uint16. A hit row is
``<query> <name>:<count/F> ...`` for counts >= min_score, count-descending
then gid-descending, each value printed as C++'s default ostream prints a
double (``%.6g``), with a trailing space; a matrix row is ``<name>\\t`` and
one value per genome (0 below min_score), each followed by a tab.
"""

from __future__ import annotations

import numpy as np
import torch

REV_C = 0xD6E8FEB86659FD93
UNREV_C = 0xCFEE444D8B59A89B
INT32_MAX = (1 << 31) - 1
BLOCK_BASES = 1 << 25           # bases per sketch block
COUNT_CELLS = 1 << 28           # compared slots per count block


def _s64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x: torch.Tensor, c: int) -> torch.Tensor:
    """revhash64 (c = REV_C) or unrevhash64 (c = UNREV_C) of int64 bit
    patterns: two rounds of x = (x >> 32 ^ x) * c, then x >> 32 ^ x,
    modulo 2^64."""
    c = _s64(c)
    x = (_shr(x, 32) ^ x) * c
    x = (_shr(x, 32) ^ x) * c
    return _shr(x, 32) ^ x


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 bit patterns as unsigned words (64 for 0)."""
    n = torch.zeros_like(x)
    y = x
    for s in (32, 16, 8, 4, 2, 1):
        z = _shr(y, 64 - s) == 0
        n = n + z.long() * s
        y = torch.where(z, y << s, y)
    return n + (y == 0).long()


class Params:
    """The sketch's parameters: k-mer length K, F = 2^lF slots, W-bit
    fingerprints of H remainder bits, and the reporting threshold J."""

    def __init__(self, K: int, lF: int, W: int, H: int, J: float):
        self.K, self.lF, self.W, self.H, self.J = K, lF, W, H, J
        self.F = 1 << lF
        self.M = W - H
        self.mask_M = (1 << self.M) - 1
        self.max_rem = (1 << H) - 1
        # the reference binary truncates J * F to an unsigned integer
        self.min_score = int(J * self.F)


def encode(seq: bytes, K: int) -> tuple[np.ndarray, np.ndarray]:
    """(forward, reverse-complement) codes of one record's text."""
    raw = np.frombuffer(seq, np.uint8)
    fwd = np.zeros(256, np.uint8)
    rc = np.zeros(256, np.uint8)
    head = np.full(256, 255, np.uint8)
    for k, ch in enumerate(b"ACGT"):
        fwd[ch], rc[ch] = k, 3 - k
        head[ch] = head[ord(chr(ch).lower())] = k
    f, r = fwd[raw].copy(), rc[raw].copy()
    n = min(K - 1, len(raw))
    h = head[raw[:n]]
    if (h == 255).any():
        h = np.zeros(n, np.uint8)
    f[:n], r[:n] = h, 3 - h
    return f, r


def canonical_kmers(fwd_codes: torch.Tensor, rc_codes: torch.Tensor,
                    K: int) -> torch.Tensor:
    """(B, L - K) canonical k-mers (int64) of (B, L) rows of forward and
    reverse-complement codes."""
    B, L = fwd_codes.shape
    n = L - K
    f, r = fwd_codes.long(), rc_codes.long()
    fwd = torch.zeros((B, n), dtype=torch.int64, device=f.device)
    rc = torch.zeros_like(fwd)
    for j in range(K):
        fwd |= f[:, j:j + n] << (2 * (K - 1 - j))
        rc |= r[:, j:j + n] << (2 * j)
    return torch.minimum(fwd, rc)


def slots_fingerprints(canon: torch.Tensor, p: Params):
    """(slot, fingerprint) int64 of each canonical k-mer."""
    hashed = mix64(canon, REV_C)
    slot = _shr(mix64(canon, UNREV_C), 64 - p.lF)
    rem = torch.clamp(p.max_rem - clz64(hashed), min=0)
    return slot, (hashed & p.mask_M) + (rem << p.M)


def raw_tables(codes: torch.Tensor, lengths: torch.Tensor, p: Params,
               rc_codes: torch.Tensor | None = None) -> torch.Tensor:
    """(B, F) int64 per-slot minimum fingerprints (-1 empty) of code rows
    padded to one width, row i holding lengths[i] real bases; the other
    strand's codes are 3 - codes unless given."""
    B = codes.shape[0]
    F = p.F
    rc_codes = 3 - codes if rc_codes is None else rc_codes
    slot, fp = slots_fingerprints(canonical_kmers(codes, rc_codes, p.K), p)
    n = slot.shape[1]
    real = torch.arange(n, device=codes.device)[None, :] < \
        (lengths - p.K)[:, None]
    rows = torch.arange(B, device=codes.device)[:, None] * (F + 1)
    flat = torch.where(real, slot, F) + rows
    t = torch.full((B * (F + 1),), INT32_MAX, dtype=torch.int64,
                   device=codes.device)
    t.scatter_reduce_(0, flat.reshape(-1), fp.reshape(-1), reduce="amin")
    t = t.view(B, F + 1)[:, :F]
    return torch.where(t == INT32_MAX, -1, t)


def _target_luts(W: int, device):
    v = torch.arange(1 << W, dtype=torch.int64, device=device)
    return mix64(v, UNREV_C), mix64(v, REV_C)


def densify_(t: torch.Tensor, W: int) -> torch.Tensor:
    """Densify (B, F) int64 tables (-1 empty, values in [0, 2^W)) in
    place; rows wholly empty stay so. A row in which a pass fills nothing,
    while every present value's stride is 0 mod F or after 4F passes,
    stops with its empty slots (the documented termination of rows that
    can never fill)."""
    B, F = t.shape
    dev = t.device
    lut_u, lut_r = _target_luts(W, dev)
    stride0 = ((lut_r & (F - 1)) == 0).to(torch.int32)
    ar = torch.arange(F, device=dev)
    rows = torch.nonzero((t == -1).any(1) & (t != -1).any(1)).squeeze(1)
    cur = t[rows].int()             # the rows still to fill, values int32
    step = 0
    while rows.numel():
        b = len(rows)
        empty = cur == -1
        tl = ((lut_u + step * lut_r) & (F - 1))
        tgt = torch.where(empty, F, tl[cur.clamp(min=0)])
        win = torch.full((b, F + 1), F, dtype=torch.int64, device=dev)
        win.scatter_reduce_(1, tgt, ar.expand(b, F), reduce="amin")
        win = win[:, :F]
        fill = empty & (win < F)
        filled_any = fill.any(1)
        cur = torch.where(fill, cur.gather(1, win.clamp(max=F - 1)), cur)
        step += 1
        done = ~(cur == -1).any(1)
        if not filled_any.all():
            # a row that filled nothing stops once every present value's
            # stride is 0 mod F, or after 4F passes
            none = ~filled_any
            zero = torch.where(empty, 1, stride0[cur.clamp(min=0)]).all(1)
            done |= none & (zero | (step > 4 * F))
        if done.any():
            t[rows[done]] = cur[done].long()
            rows, cur = rows[~done], cur[~done]
    return t


def sketches(codes: np.ndarray, offsets: np.ndarray, p: Params, device,
             rows=None, out_dtype=torch.int16) -> torch.Tensor:
    """(n, F) final sketches (-1 empty) on ``device`` of the genomes
    ``rows`` (default all) of a flat code array with genome i at
    codes[offsets[i]:offsets[i + 1]]. Genomes go in blocks of similar
    length."""
    rows = np.arange(len(offsets) - 1) if rows is None \
        else np.asarray(rows, np.int64)
    lens = (offsets[1:] - offsets[:-1])[rows]
    out = torch.full((len(rows), p.F), -1, dtype=out_dtype, device=device)
    order = np.argsort(lens, kind="stable")
    a = 0
    while a < len(order):
        Lmax = int(lens[order[a]])
        b = a + 1
        while b < len(order) and (b - a + 1) * int(lens[order[b]]) \
                <= BLOCK_BASES:
            b += 1
        idx = order[a:b]
        Lmax = int(lens[idx].max())
        blk = np.zeros((len(idx), Lmax), np.uint8)
        for r, i in enumerate(idx):
            g = rows[i]
            blk[r, :lens[i]] = codes[offsets[g]:offsets[g + 1]]
        t = raw_tables(torch.from_numpy(blk).to(device),
                       torch.from_numpy(lens[idx]).to(device), p)
        out[torch.from_numpy(idx).to(device)] = \
            densify_(t, p.W).to(out_dtype)
        a = b
    return out


def sketch_text(seq: bytes, p: Params) -> np.ndarray:
    """(F,) final sketch (-1 empty) of one record given as text."""
    f, r = encode(seq, p.K)
    t = raw_tables(torch.from_numpy(f)[None], torch.tensor([len(f)]), p,
                   torch.from_numpy(r)[None])
    return densify_(t, p.W)[0].numpy().astype(np.int32)


def counts(q: torch.Tensor, x: torch.Tensor, W: int) -> np.ndarray:
    """(nq, G) equal-slot counts of sketches q (nq, F) against x (G, F) on
    one device; fingerprints outside [0, 2^W) match nothing."""
    lim = 1 << W
    qs = torch.where((q < 0) | (q >= lim), -3, q.int())
    nq, F = q.shape
    step = max(1, COUNT_CELLS // max(1, nq * F))
    out = []
    for a in range(0, x.shape[0], step):
        xs = x[a:a + step].int()
        xs = torch.where((xs < 0) | (xs >= lim), -2, xs)
        out.append((qs[:, None, :] == xs[None, :, :]).sum(-1,
                                                          dtype=torch.int32))
    return torch.cat(out, 1).cpu().numpy()


def g6(v: float) -> str:
    """A double as C++'s default ostream prints it."""
    return "%.6g" % v


def hits_row(query: str, c: np.ndarray, names, p: Params) -> str:
    """The pretty hit row of one query's counts over the index."""
    sel = np.nonzero(c >= p.min_score)[0]
    order = sel[np.lexsort((-sel, -c[sel].astype(np.int64)))]
    return query + " " + "".join(f"{names[g]}:{g6(c[g] / p.F)} "
                                 for g in order) + "\n"


def matrix_row(name: str, c: np.ndarray, p: Params) -> str:
    """One dense matrix row of a genome's counts (uint16 counters)."""
    c = np.asarray(c, np.int64) & 0xFFFF
    return name + "\t" + "".join(
        (g6(v / p.F) if v >= p.min_score else "0") + "\t"
        for v in c.tolist()) + "\n"


def matrix_header(names) -> str:
    return "##Names\t" + "".join(n + "\t" for n in names) + "\n"
