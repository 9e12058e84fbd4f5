"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with one (and without JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Results must be identical (integer semantics, tolerance 0).
"""

import numpy as np
import pytest
import torch

from niqki_tpu_torch import kernels
from niqki_tpu_torch.ops import bcount, pcount, psort

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_psort(xd, x):
    """One launch, equal to torch.sort, input untouched."""
    before = kernels.LAUNCHES["psort"]
    got = psort.sort_i32_pow2_batch(xd)
    assert kernels.LAUNCHES["psort"] == before + 1
    assert torch.equal(got, psort.sort_plain(xd))
    assert torch.equal(xd.cpu(), torch.from_numpy(x))


@pytest.mark.parametrize("B,m", [
    (1, 10), (3, 12), (2, 13), (5, 15), (3, 16), (2, 17), (1, 18), (4, 14),
    (256, 17), (1, 23), (6, 23), (7, 10), (3, 11)])
def test_psort_kernel_matches_plain(card, B, m):
    """Random rows at every tile size (2^10 and 2^11 below one 4096-key
    tile) up to the main path's 256 x 2^17 and 6 x 2^23."""
    rng = np.random.default_rng(m)
    x = rng.integers(-2**31, 2**31, (B, 1 << m)).astype(np.int32)
    if m == 14:
        x %= 5                                   # heavy duplicates
    _check_psort(torch.from_numpy(x).to(card), x)


@pytest.mark.parametrize("kind", ["edges", "constant", "sketch_keys"])
@pytest.mark.parametrize("m", [10, 17])
def test_psort_kernel_special_rows(card, kind, m):
    """Rows of INT32_MIN / INT32_MAX / -1 / 0 (the sign flip), rows of one
    value (every key in one digit bucket each pass), and sketch-like keys
    below 2^27 with 45% INT32_MAX padding (the skewed top digit)."""
    rng = np.random.default_rng(len(kind) + m)
    N = 1 << m
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if kind == "edges":
        x = rng.choice(np.array([lo, hi, -1, 0, lo + 1, hi - 1, 1, -2],
                                np.int32), (4, N))
        x[0] = rng.integers(lo, hi, N, dtype=np.int32)   # edges sprinkled
        x[0, ::7], x[0, 1::7], x[0, 2::7], x[0, 3::7] = lo, hi, -1, 0
    elif kind == "constant":
        x = np.stack([np.full(N, v, np.int32) for v in (lo, -1, 0, hi, 12345)])
    else:
        x = rng.integers(0, 1 << 27, (3, N)).astype(np.int32)
        x[rng.random(x.shape) < 0.45] = hi
    _check_psort(torch.from_numpy(np.ascontiguousarray(x)).to(card), x)


def _bcount_planes(card, P, Qb, G, L):
    rng = np.random.default_rng(P * 1000 + Qb)
    W = P - 1
    g = rng.integers(-3, 6, (G, L * 32)).astype(np.int32)
    q = rng.integers(-3, 6, (Qb, L * 32)).astype(np.int32)
    xp = bcount.pack_bitplanes(torch.from_numpy(g).to(card), W=W,
                               query=False)
    qp = bcount.pack_bitplanes(torch.from_numpy(q).to(card), W=W,
                               query=True)
    return qp, xp


def _check_bcount(qp, xp):
    """One launch, equal to the plain version; returns the counts."""
    before = kernels.LAUNCHES["bcount"]
    got = bcount._bcount_call(qp, xp)
    assert kernels.LAUNCHES["bcount"] == before + 1
    assert torch.equal(got, bcount._bcount_plain(qp, xp))
    assert int(got.max()) > 0
    return got


@pytest.mark.parametrize("P,Qb,G,L", [
    (13, 96, 4096, 1024), (17, 96, 4096, 1024), (13, 7, 200, 128),
    (31, 100, 300, 8), (2, 33, 65, 16), (13, 768, 4096, 1024),
    (13, 96, 256, 1024), (13, 97, 4097, 1024), (31, 96, 4096, 1024),
    (16, 200, 1000, 64)])
def test_bcount_kernel_matches_plain(card, P, Qb, G, L):
    """Every route of bcount._plan: one tile row with the lanes split
    (96 x 256 into 128 ranges of 8 lanes; the -Q shape into 8), ragged
    query and row edges against the 96 x 128 tile (97 x 4097), the 2-lane
    chunk at P = 17 and 31 (P = 31 with L = 8: one chunk pair a block),
    the 4-lane chunk at its largest P = 16, and the -M shape unsplit."""
    _check_bcount(*_bcount_planes(card, P, Qb, G, L))


@pytest.mark.parametrize("lo,B", [(0, 768), (768, 768), (4000, 96)])
def test_bcount_self_join_shapes(card, lo, B):
    """The self-join's query planes, index rows re-encoded by
    _planes_as_queries: a MATRIX_BLOCK of the sweep and the 96-row overflow
    re-fetch at the index's ragged end (G = 4096 + 5 rows)."""
    _, xp = _bcount_planes(card, 13, 1, 4101, 1024)
    qp = bcount._planes_as_queries(xp, lo, B)
    got = _check_bcount(qp, xp)
    rows = torch.arange(qp.shape[1], device=card)
    assert torch.equal(got[rows, lo + rows], got.max(dim=1).values)


def test_bcount_split_launches_agree(card):
    """Two launches on one input give one output: the lane-split partial
    counts are added with integer atomics, exact in any order."""
    qp, xp = _bcount_planes(card, 13, 96, 4096, 1024)
    assert bcount._plan(13, 96, 4096, 1024)["split"] > 1
    a = bcount._bcount_call(qp, xp)
    b = bcount._bcount_call(qp, xp)
    assert torch.equal(a, b)
    assert torch.equal(a, bcount._bcount_plain(qp, xp))


def test_bcount_rejects_planes_out_of_range(card):
    qp = torch.zeros((32, 4, 16), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="2 <= P <= 31"):
        bcount._bcount_call(qp, qp)


def test_bcount_rejects_misaligned_lanes(card):
    qp = torch.zeros((13, 4, 12), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="L % 8"):
        bcount._bcount_call(qp, qp)


def _pcount_rows(Qb, G, F):
    """Random int16 fingerprints with clustered rows so counts reach F,
    stored -2 and query -3 sentinels and negative halves; query 0 equals
    row 0 and query Qb-1 shares half of row 1."""
    rng = np.random.default_rng(Qb * 7 + G + F)
    g = rng.integers(-2, 1 << 14, (G, F)).astype(np.int16)
    g[: min(G, 50)] = g[0]
    q = rng.integers(-3, 1 << 14, (Qb, F)).astype(np.int16)
    q[0] = g[0]
    q[-1, : F // 2] = g[1, : F // 2]
    q[q == -2] = -3
    return q, g


@pytest.mark.parametrize("Qb,G,F", [
    (64, 4096, 1024), (64, 102400, 1024), (64, 4096, 2048), (7, 200, 256),
    (100, 300, 512), (1, 65, 64), (130, 4096, 1024), (4096, 4096, 1024),
    (96, 4096, 1024), (129, 4097, 1024), (4, 300, 1 << 17)])
def test_pcount_kernel_matches_plain(card, Qb, G, F):
    """K3 at the main path's shapes (the whole -M call, 4096 x 4096 at
    S = 10, split into none; the -Q call, 96 x 4096, split 8 ways; 64
    queries against G = 4096 and 102,400 at S = 10, and S = 11), ragged
    edges against the 128 x 128 tile (129 x 4097, 130 x 4096, 7 x 200,
    1 x 65) and F = 2^17, whose 65,536 lanes the plan cuts into ranges
    within the 16-bit counters, with a query equal to a row."""
    q, g = _pcount_rows(Qb, G, F)
    xp = pcount.pack_rows(torch.from_numpy(g).to(card))
    qp = pcount.pack_rows(torch.from_numpy(q).to(card))
    before = kernels.LAUNCHES["pcount"]
    got = pcount._count_call(qp, xp)
    assert kernels.LAUNCHES["pcount"] == before + 1
    assert torch.equal(got, pcount._count_plain(qp, xp))
    assert int(got[0, 0]) == F and int(got.max()) == F


def test_pcount_split_launches_agree(card):
    """Two launches on one input give one output: the lane-split partial
    counts are added with integer atomics, exact in any order."""
    q, g = _pcount_rows(96, 4096, 1024)
    xp = pcount.pack_rows(torch.from_numpy(g).to(card))
    qp = pcount.pack_rows(torch.from_numpy(q).to(card))
    assert pcount._plan(96, 4096, 512)["split"] > 1
    a = pcount._count_call(qp, xp)
    b = pcount._count_call(qp, xp)
    assert torch.equal(a, b)
    assert torch.equal(a, pcount._count_plain(qp, xp))


def test_match_counts_packed_launches(card, monkeypatch):
    """A whole count call is one launch at G = 4096 with 4096 queries, and
    as many launches as _launch_ranges gives once the output budget is
    crossed; the counts are the same either way."""
    G = 4096
    q, g = _pcount_rows(G, G, 1024)
    gp = pcount.pack_rows(torch.from_numpy(g).to(card))
    want = pcount._count_plain(pcount.pack_rows(
        torch.from_numpy(q).to(card)), gp).cpu().numpy()
    kernels.reset_launches()
    np.testing.assert_array_equal(pcount.match_counts_packed(q, gp, G), want)
    assert kernels.LAUNCHES["pcount"] == 1
    monkeypatch.setattr(pcount, "OUT_BUDGET", 1000 * G)
    n = len(pcount._launch_ranges(G, G, pcount.OUT_BUDGET))
    assert n == 5
    np.testing.assert_array_equal(pcount.match_counts_packed(q, gp, G), want)
    assert kernels.LAUNCHES["pcount"] == 1 + n


def test_pcount_rejects_misaligned_lanes(card):
    qp = torch.zeros((4, 48), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="Fp % 32"):
        pcount._count_call(qp, qp)
