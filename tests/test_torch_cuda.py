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


@pytest.mark.parametrize("B,m,chunk_log", [
    (1, 10, None), (3, 12, 10), (2, 13, 11), (5, 15, None), (3, 16, None),
    (2, 17, None), (1, 18, 12), (4, 14, 1), (256, 17, None), (1, 23, None)])
def test_psort_kernel_matches_plain(card, B, m, chunk_log):
    rng = np.random.default_rng(m)
    x = rng.integers(-2**31, 2**31, (B, 1 << m)).astype(np.int32)
    if m == 14:
        x %= 5                                   # heavy duplicates
    xd = torch.from_numpy(x).to(card)
    before = kernels.LAUNCHES["psort"]
    got = psort.sort_i32_pow2_batch(xd, chunk_log=chunk_log)
    assert kernels.LAUNCHES["psort"] == before + 1
    assert torch.equal(got, psort.sort_plain(xd))
    assert torch.equal(xd.cpu(), torch.from_numpy(x))     # input untouched


@pytest.mark.parametrize("P,Qb,G,L", [
    (13, 96, 4096, 1024), (17, 96, 4096, 1024), (13, 7, 200, 128),
    (31, 100, 300, 8), (2, 33, 65, 16), (13, 768, 4096, 1024)])
def test_bcount_kernel_matches_plain(card, P, Qb, G, L):
    rng = np.random.default_rng(P * 1000 + Qb)
    W = P - 1
    g = rng.integers(-3, 6, (G, L * 32)).astype(np.int32)
    q = rng.integers(-3, 6, (Qb, L * 32)).astype(np.int32)
    xp = bcount.pack_bitplanes(torch.from_numpy(g).to(card), W=W,
                               query=False)
    qp = bcount.pack_bitplanes(torch.from_numpy(q).to(card), W=W,
                               query=True)
    before = kernels.LAUNCHES["bcount"]
    got = bcount._bcount_call(qp, xp)
    assert kernels.LAUNCHES["bcount"] == before + 1
    assert torch.equal(got, bcount._bcount_plain(qp, xp))
    assert int(got.max()) > 0


def test_bcount_rejects_misaligned_lanes(card):
    qp = torch.zeros((13, 4, 12), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="L % 8"):
        bcount._bcount_call(qp, qp)


@pytest.mark.parametrize("Qb,G,F", [
    (64, 4096, 1024), (64, 102400, 1024), (64, 4096, 2048), (7, 200, 256),
    (100, 300, 512), (1, 65, 64), (130, 4096, 1024)])
def test_pcount_kernel_matches_plain(card, Qb, G, F):
    """K3 at the main path's shapes (64 queries against G = 4096 and
    102,400 at S = 10, and S = 11) and ragged edges; clustered rows so
    counts reach F, stored -2 and query -3 sentinels, negative halves."""
    rng = np.random.default_rng(Qb * 7 + G + F)
    g = rng.integers(-2, 1 << 14, (G, F)).astype(np.int16)
    g[: min(G, 50)] = g[0]
    q = rng.integers(-3, 1 << 14, (Qb, F)).astype(np.int16)
    q[0] = g[0]
    q[-1, : F // 2] = g[1, : F // 2]
    q[q == -2] = -3
    xp = pcount.pack_rows(torch.from_numpy(g).to(card))
    qp = pcount.pack_rows(torch.from_numpy(q).to(card))
    before = kernels.LAUNCHES["pcount"]
    got = pcount._count_call(qp, xp)
    assert kernels.LAUNCHES["pcount"] == before + 1
    assert torch.equal(got, pcount._count_plain(qp, xp))
    assert int(got[0, 0]) == F and int(got.max()) == F


def test_pcount_rejects_misaligned_lanes(card):
    qp = torch.zeros((4, 48), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="Fp % 32"):
        pcount._count_call(qp, qp)
