"""The plain reference: NIQKI's golden matrix, a hand-worked hit row, and
the port's own numpy oracle on random records."""

import gzip
import os

import numpy as np
import pytest
import torch

from benchmark import reference as ref

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIX = os.path.join(REPO, "tests", "fixtures")


def _record(path):
    lines = open(path, "rb").read().split(b"\n")
    return b"".join(ln.rstrip(b"\r") for ln in lines[1:]
                    if ln and not ln.startswith(b">"))


def test_golden_matrix_of_the_reference_binary():
    """tests/fixtures/matrix_s16_tiny.gz: NIQKI's -M of fof_tiny.txt at
    S=16, K=21 (tiny2.fa holds N and lowercase bases; self-counts of F
    wrap the uint16 counters to 0)."""
    p = ref.Params(21, 16, 12, 4, 0.0)
    names = ["tiny1.fa", "tiny2.fa", "tiny3.fa"]
    x = torch.from_numpy(np.stack([ref.sketch_text(
        _record(os.path.join(FIX, n)), p) for n in names]))
    c = ref.counts(x, x, p.W)
    text = ref.matrix_header(names) + "".join(
        ref.matrix_row(n, c[i], p) for i, n in enumerate(names))
    with gzip.open(os.path.join(FIX, "matrix_s16_tiny.gz")) as f:
        assert text == f.read().decode()


def test_hit_row_order_and_format():
    p = ref.Params(31, 4, 12, 4, 0.25)         # F=16, min_score 4
    c = np.array([16, 3, 8, 8, 4])
    names = [">a", ">b", ">c", ">d", ">e"]
    assert ref.hits_row("q.fa", c, names, p) == \
        "q.fa >a:1 >d:0.5 >c:0.5 >e:0.25 \n"
    assert ref.matrix_row(">a", c, p) == ">a\t1\t0\t0.5\t0.5\t0.25\t\n"


def test_counts_match_nothing_outside_the_fingerprint_range():
    q = torch.tensor([[1, -1, 4096, 7]])
    x = torch.tensor([[1, -1, 4096, 7], [1, 2, 3, 4]])
    assert ref.counts(q, x, 12).tolist() == [[2, 1]]


@pytest.mark.parametrize("lF,L", [(8, 300), (10, 800), (12, 3000),
                                  (12, 12000), (6, 40)])
def test_sketches_equal_the_ports_oracle(lF, L):
    from niqki_tpu_torch import oracle
    from niqki_tpu_torch.params import SketchParams
    rng = np.random.default_rng(lF * 1000 + L)
    lens = rng.integers(max(32, L // 2), L + 1, 5)
    codes = rng.integers(0, 4, lens.sum()).astype(np.uint8)
    off = np.concatenate([[0], np.cumsum(lens)])
    got = ref.sketches(codes, off, ref.Params(31, lF, 12, 4, 0.0),
                       "cpu").numpy()
    for i in range(5):
        seq = np.frombuffer(b"ACGT", np.uint8)[codes[off[i]:off[i + 1]]]
        want = oracle.sketch_record(seq.tobytes(), SketchParams(lF=lF))
        assert (want == got[i]).all()


def test_text_records_equal_the_ports_oracle():
    from niqki_tpu_torch import oracle
    from niqki_tpu_torch.params import SketchParams
    seq = _record(os.path.join(FIX, "tiny2.fa"))
    assert (ref.sketch_text(seq, ref.Params(31, 10, 12, 4, 0.0))
            == oracle.sketch_record(seq, SketchParams(lF=10))).all()
