"""``engine.query_matrix`` on rows drawn by ``benchmark/sketchgen.py``
against the benchmark's plain reference (``benchmark/reference.py``):
the header and every row, byte for byte, on each route (the symmetric
sweep, the full sweep, the dense loop). And the drawn rows themselves:
members of a cluster share about q_i q_j of their slots, in [0.79, 0.97]
up to sampling error, and members of different clusters less than J.

The rows: S=12, 4 clusters of 48 members, ancestors of 60 kb sketched by
the reference; blocks of 64 rows, so clusters straddle blocks and the
symmetric sweep mirrors across them.
"""

import gzip
import os
import sys

import numpy as np
import pytest
import torch

from niqki_tpu_torch import SketchIndex, engine, native
from niqki_tpu_torch.io.writers import GzTextWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import common, sketchgen  # noqa: E402
from benchmark import reference as ref  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

CFG = {"params": {"K": 31, "S": 12, "W": 12, "H": 4, "J": 0.1},
       "genomes": {"G": 192, "clusters": 4, "length": 60000,
                   "keep": [0.89, 0.985]}}
ROUTES = {"sym": {}, "full": {"NIQKI_TPU_MATRIX_SYM": "off"},
          "dense": {"NIQKI_TPU_MATRIX": "dense"}}


@pytest.fixture(scope="module")
def drawn():
    """The rows, their reference counts and the reference's text."""
    r = sketchgen.make_rows(CFG, 2**33 + 29, "cpu")
    x = torch.from_numpy(r.rows)
    p = common.reference_params(CFG)
    c = ref.counts(x, x, p.W)
    text = (ref.matrix_header(r.names) + "".join(
        ref.matrix_row(n, c[g], p) for g, n in enumerate(r.names))).encode()
    return r, c, text


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_row_equals_the_reference(route, drawn, monkeypatch,
                                        tmp_path):
    r, _, want = drawn
    for k, v in {"NIQKI_TPU_MATRIX": "selfjoin",
                 "NIQKI_TPU_MATRIX_BLOCK": "64",
                 "NIQKI_TPU_MATRIX_QB": "2", **ROUTES[route]}.items():
        monkeypatch.setenv(k, v)
    idx = SketchIndex.from_arrays(common.program_params(CFG), r.names,
                                  r.rows, device="cpu")
    path = tmp_path / "m.gz"
    with GzTextWriter(str(path)) as out:
        engine.query_matrix(idx, out)
    with gzip.open(path, "rb") as f:
        got = f.read()
    assert got.split(b"\n") == want.split(b"\n")


def test_the_drawn_rows_share_what_the_configuration_says(drawn):
    r, c, _ = drawn
    F = 1 << CFG["params"]["S"]
    share = c / F
    same = r.cluster[:, None] == r.cluster[None, :]
    within = share[same & ~np.eye(r.G, dtype=bool)]
    # q_i q_j lies in [0.89^2, 0.985^2]; a share of F slots strays from
    # it by at most about 5 standard deviations, sqrt(0.25 / F) each
    err = 5 * (0.25 / F) ** 0.5
    assert 0.79 - err <= within.min() and within.max() <= 0.97 + err
    assert share[~same].max() < CFG["params"]["J"]
    assert (r.rows >= 0).all() and (r.rows < 1 << 12).all()
    assert list(np.bincount(r.cluster)) == [48] * 4
