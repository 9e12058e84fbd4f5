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
from niqki_tpu_torch.ops import bcount, psort

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
