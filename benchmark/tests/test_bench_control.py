"""The control: the reference with fingerprints one bit narrower, in the
program's place, fails each cell's own comparison (the loop's ``judge``);
the reference itself passes it."""

import pytest
import torch

from benchmark import harness
from small import cell_parts

CELLS = ["synth100k_s12.query", "synth100k_s12.lookup",
         "synth100k_s12.ingest"]


def _control(cell, bits):
    torch.set_num_threads(4)
    cfg, traffic = cell_parts(cell)
    cfg["genomes"].update(G=512)
    return harness.control_run(cell, 2**31 + 7, bits, device="cpu",
                               config=cfg, traffic=traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(cell):
    got = _control(cell, 1)
    assert got["correct"] is False, got
    assert max(c["value"] for c in got["checks"].values()) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_the_controls_place_passes(cell):
    got = _control(cell, 0)
    assert got["correct"] is True, got
    assert {c["value"] for c in got["checks"].values()} == {0}
