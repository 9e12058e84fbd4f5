"""Pure-NumPy sketching math, bit for bit with the reference.

The port's counterpart of ``niqki_tpu/oracle.py``, with what the port calls:
``encode_record`` (the Python fallback of the native packed reader) and the
numpy backend's ``sketch_records`` with the math behind it: the rolling
2-bit codec with the reference's non-ACGT and seed-prefix quirks, the last
k-mer never consumed, canonical min, revhash64/unrevhash64, the
HyperMinHash fingerprint, and one-permutation-hashing densification in
sequential scan order (also the host densify when the native library is
absent).

For multi-record inputs accumulated into one sketch the reference miscounts
empty cells and can loop forever; this tracks the true empty-cell count,
which is identical for single-record files.
"""

from __future__ import annotations

import numpy as np

from .params import SketchParams

REV_C = np.uint64(0xD6E8FEB86659FD93)
UNREV_C = np.uint64(0xCFEE444D8B59A89B)
_U32 = np.uint64(32)

# Rolling forward codes: A=0, C=1, G=2, T=3, everything else (incl. lowercase) 0.
_FWD_LUT = np.zeros(256, dtype=np.uint8)
_FWD_LUT[ord("C")] = 1
_FWD_LUT[ord("G")] = 2
_FWD_LUT[ord("T")] = 3

# Rolling reverse-complement codes: A=3, C=2, G=1, everything else 0.
_RC_LUT = np.zeros(256, dtype=np.uint8)
_RC_LUT[ord("A")] = 3
_RC_LUT[ord("C")] = 2
_RC_LUT[ord("G")] = 1

# Seed-prefix codes (case-insensitive); 255 marks an invalid character which
# zeroes the whole prefix.
_SEED_LUT = np.full(256, 255, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _SEED_LUT[ord(_c)] = _v
    _SEED_LUT[ord(_c.lower())] = _v


def encode_record(seq: bytes | str, K: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode one sequence into effective per-base code arrays.

    Returns (eff_fwd, eff_rc), uint8 arrays of len(seq) entries such that
      fwd_kmer[i] = sum_j eff_fwd[i+j] << 2*(K-1-j)
      rc_kmer[i]  = sum_j eff_rc[i+j]  << 2*j
    reproduce the reference's rolling k-mer states exactly, including the
    seed-prefix behavior for the first K-1 positions.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    eff_fwd = _FWD_LUT[raw]
    eff_rc = _RC_LUT[raw]
    # Seed prefix: first K-1 positions come from the case-insensitive packer,
    # which returns 0 for the *whole* prefix if any character is invalid.
    p = min(K - 1, len(raw))
    seed = _SEED_LUT[raw[:p]]
    if (seed == 255).any():
        seed = np.zeros(p, dtype=np.uint8)
    eff_fwd = eff_fwd.copy()
    eff_rc = eff_rc.copy()
    eff_fwd[:p] = seed
    eff_rc[:p] = 3 - seed
    return eff_fwd, eff_rc


def kmers_from_codes(eff_fwd: np.ndarray, eff_rc: np.ndarray, K: int):
    """All (fwd, rc) k-mer values as uint64 arrays of length len(seq) - K.

    The count is len - K (not len - K + 1): the final k-mer is dropped, as in
    the reference's loop bound.
    """
    n = len(eff_fwd) - K
    if n <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(K):
        fwd |= eff_fwd[j : j + n].astype(np.uint64) << np.uint64(2 * (K - 1 - j))
        rc |= eff_rc[j : j + n].astype(np.uint64) << np.uint64(2 * j)
    return fwd, rc


def revhash64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    x = ((x >> _U32) ^ x) * REV_C
    x = ((x >> _U32) ^ x) * REV_C
    return (x >> _U32) ^ x


def unrevhash64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    x = ((x >> _U32) ^ x) * UNREV_C
    x = ((x >> _U32) ^ x) * UNREV_C
    return (x >> _U32) ^ x


def hash_family(x, factor: int) -> np.ndarray:
    return unrevhash64(x) + np.uint64(factor) * revhash64(x)


def clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64, exactly; clz64(0) == 64.

    Uses float64 frexp on 32-bit halves (exact because 2^32 < 2^53).
    """
    x = np.asarray(x, dtype=np.uint64)
    hi = (x >> _U32).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def clz32(v: np.ndarray) -> np.ndarray:
        _, e = np.frexp(v.astype(np.float64))
        # v > 0: floor(log2 v) = e - 1, clz = 32 - e ; v == 0: frexp exp is 0.
        return np.where(v == 0, 32, 32 - e).astype(np.int64)

    return np.where(hi == 0, 32 + clz32(lo), clz32(hi))


def fingerprints(hashed: np.ndarray, p: SketchParams) -> np.ndarray:
    """HyperMinHash fingerprint of each 64-bit hash, as int32 in [0, 2^W)."""
    lz = clz64(hashed)
    rem = np.maximum(0, p.maximal_remainder - lz)
    mant = (np.asarray(hashed, np.uint64) & np.uint64(p.mask_M)).astype(np.int64)
    return (mant + (rem << p.M)).astype(np.int32)


def slots_and_fingerprints(canon: np.ndarray, p: SketchParams):
    """(slot, fingerprint) of each canonical k-mer."""
    hashed = revhash64(canon)
    slot = (unrevhash64(canon) >> np.uint64(64 - p.lF)).astype(np.int64)
    return slot, fingerprints(hashed, p)


def accumulate_sketch(
    sketch: np.ndarray, seq: bytes | str, p: SketchParams
) -> np.ndarray:
    """Min-merge one record's fingerprints into ``sketch`` then densify.

    ``sketch`` is int32 of shape (F,), -1 meaning empty; mutated in place and
    also returned. Mirrors compute_sketch()+densification per record.
    """
    eff_fwd, eff_rc = encode_record(seq, p.K)
    fwd, rc = kmers_from_codes(eff_fwd, eff_rc, p.K)
    canon = np.minimum(fwd, rc)
    slot, fp = slots_and_fingerprints(canon, p)
    empty = sketch == -1
    # np.minimum.at gives the per-slot min over all occurrences; empty slots
    # take the raw min because -1 must not win the min.
    tmp = np.where(empty, np.int32(np.iinfo(np.int32).max), sketch)
    np.minimum.at(tmp, slot, fp)
    filled = tmp != np.iinfo(np.int32).max
    sketch[:] = np.where(filled, tmp, -1)
    densify(sketch, p)
    return sketch


def _scalar_target(v: int, step: int, F: int) -> int:
    with np.errstate(over="ignore"):
        return int(hash_family(np.uint64(v), step) % np.uint64(F))


def densify(sketch: np.ndarray, p: SketchParams) -> None:
    """One-permutation-hashing densification, exact sequential order.

    Repeated ascending scans; each non-empty slot proposes target
    hash_family(value, step) % F (value-keyed, not position-keyed); a proposal
    fills an empty target immediately, making it eligible as a source later in
    the same pass. ``step`` increments per full pass.
    """
    empty_cells = int((sketch == -1).sum())
    if empty_cells == 0 or empty_cells == len(sketch):
        # All-empty would never terminate (nothing to copy); the reference can
        # only reach this with zero valid k-mers, which callers exclude.
        return
    F = len(sketch)
    step = 0
    # Cache the hash of each distinct present value per step lazily.
    while empty_cells != 0:
        vals = sketch.copy()
        # Sequential pass; values written during the pass can propagate, so we
        # cannot fully vectorize a pass. Vectorize the hash precomputation.
        h_unrev = unrevhash64(vals.astype(np.uint64))
        h_rev = revhash64(vals.astype(np.uint64))
        step_u = np.uint64(step)
        targets = ((h_unrev + step_u * h_rev) % np.uint64(F)).astype(np.int64)
        filled_this_pass = 0
        for i in range(F):
            v = sketch[i]
            if v == -1:
                continue
            t = (targets[i] if sketch[i] == vals[i]
                 else _scalar_target(int(v), step, F))
            if sketch[t] == -1:
                sketch[t] = v
                empty_cells -= 1
                filled_this_pass += 1
                if empty_cells == 0:
                    return
        step += 1
        # Termination divergence (documented): the reference loops forever
        # when no present value can ever reach an empty slot — e.g. a
        # poly-N/poly-A record, whose only fingerprint is 0 and
        # revhash64(0) == unrevhash64(0) == 0, pins every probe to slot 0.
        # A zero-fill pass with every per-value stride rev%F == 0 can never
        # change targets again; a generous pass cap backstops the rest.
        if filled_this_pass == 0:
            if not np.any(h_rev[vals != -1] % np.uint64(F)):
                return
            if step > 4 * F:
                return


def sketch_records(seqs, p: SketchParams) -> np.ndarray:
    """Sketch an iterable of records accumulated into one sketch (whole-file
    semantics). Records of length <= K must be filtered by the caller."""
    sketch = np.full(p.F, -1, dtype=np.int32)
    for s in seqs:
        accumulate_sketch(sketch, s, p)
    return sketch
