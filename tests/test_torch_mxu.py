"""The port's one-hot matrix-product count (``NIQKI_TPU_COUNT=mxu``)
against niqki_tpu's ``ops/mxucount``, on the shapes of
``tests/test_mxucount.py`` and across its tiles. Exact: integer counts,
tolerance 0.
"""

import numpy as np
import pytest

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import SketchParams as JaxParams
from niqki_tpu.ops import mxucount as jmxu
from niqki_tpu_torch import SketchIndex
from niqki_tpu_torch.ops import mxucount


def _ref_counts(q, g):
    return (q[:, None, :] == g[None, :, :]).sum(-1, dtype=np.int32)


def _both(q, g, W):
    """The port's counts on the CPU, held equal to niqki_tpu's."""
    got = mxucount.match_counts_mxu(q, g, W, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(q), len(g))
    np.testing.assert_array_equal(got, jmxu.match_counts_mxu(q, g, W))
    return got


def test_tiles_match_jax():
    assert (mxucount.FC, mxucount.G_TILE, mxucount.Q_TILE) == \
        (jmxu.FC, jmxu.G_TILE, jmxu.Q_TILE) == (8, 2048, 96)


@pytest.mark.parametrize("W,F,G,Q", [
    (12, 64, 130, 5),                       # F spans several FC blocks
    (12, 16, 70, mxucount.Q_TILE + 3),      # across the query tile
    (5, 24, mxucount.G_TILE + 37, 7),       # across the index tile
    (14, 8, 9, 4)])                         # the widest int16 fingerprints
def test_counts_match_jax(W, F, G, Q):
    rng = np.random.default_rng(W * F + G)
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(0, 1 << W, size=(Q, F)).astype(np.int32)
    q[0] = g[3]
    q[-1] = g[-1]
    got = _both(q, g, W)
    np.testing.assert_array_equal(got, _ref_counts(q, g))
    assert got[0, 3] == F and got[-1, -1] == F


def test_sentinels_never_match():
    """Stored -2, query -3 and values at or past 2^W have all-zero one-hot
    rows: they match nothing, not even each other."""
    W, F = 12, 32
    g = np.zeros((5, F), np.int32)
    g[1] = -2
    g[2] = 1 << W
    g[3, ::2] = -2
    q = np.zeros((3, F), np.int32)
    q[1] = -3
    q[2] = 1 << W
    got = _both(q, g, W)
    assert got[0].tolist() == [F, 0, 0, F // 2, F]
    assert not got[1:].any()


def test_rejects_mismatched_widths():
    with pytest.raises(ValueError, match="multiples"):
        mxucount.match_counts_mxu(np.zeros((1, 12), np.int32),
                                  np.zeros((2, 12), np.int32), 12, "cpu")
    with pytest.raises(ValueError, match="multiples"):
        mxucount.match_counts_mxu(np.zeros((1, 16), np.int32),
                                  np.zeros((2, 8), np.int32), 12, "cpu")


@pytest.mark.parametrize("lF", [6, 12])
def test_index_counts_mxu_route(monkeypatch, lF):
    """SketchIndex.counts under NIQKI_TPU_COUNT=mxu equals the xla route
    and niqki_tpu's mxu route, query sentinels and empty slots included;
    at F = 4096 it equals the bit-plane route too."""
    rng = np.random.default_rng(23 + lF)
    p = JaxParams(lF=lF, K=21)
    jidx = JaxIndex(p)
    for i in range(7):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        sk[rng.choice(p.F, 3, replace=False)] = -1
        jidx.insert_sketch(sk, f"g{i}")
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    q = jidx.matrix()[:3].copy()
    q[1, ::5] = -1
    q[2, ::3] = p.fingerprint_range + 2
    monkeypatch.setenv("NIQKI_TPU_COUNT", "xla")
    want = tidx.counts(q)
    monkeypatch.setenv("NIQKI_TPU_COUNT", "mxu")
    got = tidx.counts(q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jidx.counts(q))
    assert got[0, 0] == p.F - 3
    if lF == 12:
        monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
        np.testing.assert_array_equal(tidx.counts(q), got)
