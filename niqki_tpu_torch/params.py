"""Sketch/index parameterization.

The port's counterpart of ``niqki_tpu/params.py``: every constant the engine
needs, derived from the four user-facing knobs (lF aka S, K, W, H) plus the
reporting threshold ``min_fract``, with the reference's ``-G`` quirk (stale
``mask_M`` / ``maximal_remainder``).
"""

from __future__ import annotations

import dataclasses
import math

DEFAULT_LF = 15
DEFAULT_K = 31
DEFAULT_W = 12
DEFAULT_H = 4


@dataclasses.dataclass(frozen=True)
class SketchParams:
    """All static configuration for sketching and indexing.

    lF: log2 of the number of sketch slots (the reference's ``-S``).
    K:  k-mer length.
    W:  fingerprint width in bits (HyperMinHash word).
    H:  bits of the HyperLogLog exponent part; M = W - H mantissa bits.
    min_fract: minimum Jaccard estimate to report (``-J``).
    """

    lF: int = DEFAULT_LF
    K: int = DEFAULT_K
    W: int = DEFAULT_W
    H: int = DEFAULT_H
    min_fract: float = 0.0
    # -G quirk (reference parity): select_best_H updates only H and the M
    # shift; mask_M and maximal_remainder keep the values derived from the
    # PRE-tuning H. These fields carry those stale values; None means
    # "derive from H" (normal).
    stale_mask_M: int | None = None
    stale_maximal_remainder: int | None = None

    def __post_init__(self):
        if not (1 <= self.lF <= 24):
            raise ValueError(f"lF out of range [1,24]: {self.lF}")
        if not (2 <= self.K <= 31):
            raise ValueError(f"K out of range [2,31]: {self.K}")
        if not (1 <= self.W <= 30):
            raise ValueError(f"W out of range [1,30]: {self.W}")
        if not (0 <= self.H <= self.W):
            raise ValueError(f"H out of range [0,W]: {self.H}")

    # -- derived constants -------------------------------------------------
    @property
    def F(self) -> int:
        """Number of sketch slots (2^lF)."""
        return 1 << self.lF

    @property
    def M(self) -> int:
        """MinHash mantissa bits."""
        return self.W - self.H

    @property
    def fingerprint_range(self) -> int:
        return 1 << self.W

    @property
    def mask_M(self) -> int:
        if self.stale_mask_M is not None:
            return self.stale_mask_M
        return (1 << self.M) - 1

    @property
    def maximal_remainder(self) -> int:
        if self.stale_maximal_remainder is not None:
            return self.stale_maximal_remainder
        return (1 << self.H) - 1

    @property
    def min_score(self) -> int:
        # uint32 truncation of min_fract * F, as the reference does.
        return int(self.min_fract * self.F)

    @property
    def kmer_mask(self) -> int:
        """4^K - 1: mask keeping a k-mer in its 2K low bits."""
        return (1 << (2 * self.K)) - 1

    def with_best_H(self, genome_size: float) -> "SketchParams":
        """Return params with H auto-tuned for an expected genome size.

        Scans H in [2, 6] maximizing the collision/saturation interval score
        (closed form with epsilon = 0.02), like the reference's -G option —
        including its quirk: only H and the M shift update; mask_M and
        maximal_remainder keep the pre-tuning values (bit-parity requires
        reproducing the stale constants in every fingerprint).
        """
        x = genome_size / self.F
        best_score = 0.0
        best_h = self.H
        for try_h in range(2, 7):
            s = score_H(x, try_h, self.W)
            if s > best_score:
                best_score = s
                best_h = try_h
        return dataclasses.replace(
            self, H=best_h,
            stale_mask_M=self.mask_M,
            stale_maximal_remainder=self.maximal_remainder)


def score_H(x: float, try_h: int, W: int, epsilon: float = 0.02) -> float:
    """Interval score for a candidate H given x = genome_size / F."""
    try_m = W - try_h
    ua = (1.0 - (1.0 - epsilon) ** (1.0 / x)) * 2.0 ** 64
    ia = math.log2(ua) + 2.0 ** try_h - 64
    ja = ua * 2.0 ** (try_m - 64 - ia + 2.0 ** try_h)
    if ua < 2.0 ** (64 - 2.0 ** try_h + 1):
        ka = ua * 2.0 ** (2.0 ** try_h - 64 - (W - try_h) - 1)
    else:
        ka = ia * 2.0 ** try_m + ja
    ub = (1.0 - epsilon ** (1.0 / x)) * 2.0 ** 64
    ib = math.log2(ub) + 2.0 ** try_h - 64
    jb = ub * 2.0 ** (try_m - 64 - ib + 2.0 ** try_h)
    if ub < 2.0 ** (64 - 2.0 ** try_h + 1):
        kb = ub * 2.0 ** (2.0 ** try_h - 64 - (W - try_h) - 1)
    else:
        kb = ib * 2.0 ** try_m + jb
    return kb - ka
