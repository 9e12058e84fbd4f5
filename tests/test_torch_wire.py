"""The port's int16 query wire into K2 against the JAX package on the same
inputs, on the CPU: match_counts_planes over blocks with a short, unpadded
last one (dense counts and top-k), match_counts_bitplane against
``niqki_tpu.ops.bcount.match_counts_bitplane`` in Pallas interpret mode,
and SketchIndex.counts / hits on the K2 route. The port's K2 wrapper takes
its plain version for CPU tensors. Counts are compared exactly
(tolerance 0).
"""

import numpy as np
import pytest

from niqki_tpu import native
from niqki_tpu.ops import bcount as jb
from niqki_tpu_torch import SketchIndex
from niqki_tpu_torch.ops import bcount
from niqki_tpu_torch.params import SketchParams

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")


def _queries(rng, B, F, W, g=None):
    """Sanitized int16 queries (values in [-3, 2^W)): 10% -3 slots, one
    all-invalid row, one row of the largest value, and rows copied from
    index rows ``g`` (with their own -3 slots) so counts are large."""
    q = rng.integers(0, 1 << W, (B, F)).astype(np.int16)
    if g is not None:
        k = min(B, len(g)) // 2
        q[:k] = np.where(g[:k] >= 0, g[:k], -3)
    q[rng.random((B, F)) < 0.1] = -3
    q[B // 2] = -3
    if B > 2:
        q[B - 1] = (1 << W) - 1
    return q


def _index(rng, G, F, W):
    g = rng.integers(0, 1 << W, (G, F)).astype(np.int32)
    g[rng.random((G, F)) < 0.02] = -2
    g[1] = g[0]
    return g


@pytest.mark.parametrize("W", [10, 12, 13])
def test_match_counts_planes_short_last_block(monkeypatch, W):
    """match_counts_planes over blocks of 16 with a short last one, each
    block shipped unpadded at its own B (16, 16, 8 launches of the count),
    == the plain equality count of the sanitized queries against the
    valid index slots, in dense counts and top-k; out-of-range query
    values are sanitized to -3 and match nothing."""
    F, G, Q = 1024, 100, 40
    rng = np.random.default_rng(W)
    g = _index(rng, G, F, W)
    q = _queries(rng, Q, F, W, g).astype(np.int32)
    q[3, :10] = 1 << W
    xp = bcount.build_index_planes(g, W, "cpu")
    monkeypatch.setattr(bcount, "BLOCK_Q", 16)
    rows = []
    orig = bcount._pack_count_call
    monkeypatch.setattr(bcount, "_pack_count_call",
                        lambda blk, x, W: rows.append(len(blk))
                        or orig(blk, x, W=W))
    dense = bcount.match_counts_planes(q, xp, G, W)
    vals, idx = bcount.match_counts_planes(q, xp, G, W, topk=6,
                                           min_score=2)
    assert rows == [16, 16, 8] * 2
    qs = np.where((q < 0) | (q >= (1 << W)), -3, q)
    want = ((qs[:, None, :] == g[None]) & (g[None] >= 0)).sum(
        -1, dtype=np.int32)
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(vals, -np.sort(-want, axis=1)[:, :6]
                                  * (-np.sort(-want, axis=1)[:, :6] >= 2))
    np.testing.assert_array_equal(
        np.take_along_axis(dense, idx.astype(np.int64), 1)[vals >= 2],
        vals[vals >= 2])


@pytest.mark.parametrize("W,G", [(12, 64), (9, 37), (14, 50), (7, 19)])
def test_match_counts_bitplane_matches_jax(monkeypatch, W, G):
    """match_counts_bitplane (both sides packed, then match_counts_planes)
    == niqki_tpu's (interpret mode, its BLOCK_Q cut to 16 for a small
    interpret kernel) at F = 4096, with the JAX package's default wire on
    its side and int16 on the port's."""
    F, Q = 4096, 20
    rng = np.random.default_rng(G)
    g = _index(rng, G, F, W)
    q = _queries(rng, Q, F, W, g).astype(np.int32)
    monkeypatch.setattr(jb, "BLOCK_Q", 16)
    want = np.asarray(jb.match_counts_bitplane(q, g, W, interpret=True))
    got = bcount.match_counts_bitplane(q, g, W, device="cpu")
    assert got.shape == (Q, G)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > F // 2


def test_index_counts_on_the_k2_route(monkeypatch):
    """SketchIndex.counts on the K2 route == the native host count, and
    hits of a row agree with hits_from_counts of the host count; the row
    and its copy come first."""
    W, F, G = 12, 4096, 50
    rng = np.random.default_rng(2)
    g = _index(rng, G, F, W)
    g[g == -2] = -1
    idx = SketchIndex.from_arrays(SketchParams(lF=12, K=21, min_fract=0.02),
                                  [f"g{i}" for i in range(G)], g,
                                  device="cpu")
    q = g[:7].copy()
    q[2] = rng.integers(0, 1 << W, F)
    want = idx.counts(q)                         # host count at G <= 2048
    monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
    np.testing.assert_array_equal(idx.counts(q), want)
    assert idx.hits(q[0]) == idx.hits_from_counts(want[0])
    assert {gid for _, gid in idx.hits(q[0])[:2]} == {0, 1}
