"""On the card (marked ``cuda``; each test skips where torch sees none):
the reference computes the same sketches there as on the CPU, and a
small run of the harness drives the port's kernels to a correct result.

    python -m pytest -m cuda benchmark/tests -q
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import reference as ref
from small import cell_parts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("lF,L", [(12, 10000), (15, 45000), (15, 5000)])
def test_reference_on_the_card_equals_the_cpu(card, lF, L):
    rng = np.random.default_rng(lF + L)
    lens = rng.integers(L // 2, L + 1, 6)
    codes = rng.integers(0, 4, lens.sum()).astype(np.uint8)
    off = np.concatenate([[0], np.cumsum(lens)])
    p = ref.Params(31, lF, 12, 4, 0.05)
    on_card = ref.sketches(codes, off, p, card).cpu()
    assert torch.equal(on_card, ref.sketches(codes, off, p, "cpu"))


def test_a_small_run_on_the_card_is_correct(card):
    cfg, traffic = cell_parts("synth100k_s12.query")
    res = harness.run("synth100k_s12.query", 5, 2.0, False, device="cuda",
                      config=cfg, traffic=traffic)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
