"""A run of each cell, on the CPU at a small size, with the program's timed
path broken underneath: ``correct`` must come out false. The harness's
look for a card is skipped (``harness.run`` on ``device='cpu'``); the rest
of the run is the benchmark's own: set-up, window, reference, checks.

Faults, as each cell can have them: an answer altered where it is produced
(every K2 count one lower), half of a batch left out, and a step that
returns its state unchanged (no rows written, an ingest that inserts
nothing, a lookup that answers with the previous answer). The cells run on
one chip, so there is no exchange between chips to leave out.
"""

import pytest
import torch

from benchmark import harness
from small import cell_parts


def _k2_one_less(monkeypatch):
    from niqki_tpu_torch.ops import bcount
    orig = bcount._bcount_call
    monkeypatch.setattr(bcount, "_bcount_call",
                        lambda qp, xp: (orig(qp, xp) - 1).clamp_(min=0))


def _hits_half_batch(monkeypatch):
    from niqki_tpu_torch.index import SketchIndex
    orig = SketchIndex.pretty_hits_batch

    def half(self, q, headers):
        n = max(1, len(headers) // 2)
        return orig(self, q[:n], headers[:n])
    monkeypatch.setattr(SketchIndex, "pretty_hits_batch", half)


def _fof_writes_nothing(monkeypatch):
    from niqki_tpu_torch import engine
    monkeypatch.setattr(engine, "query_fof_whole", lambda idx, fof, out:
                        None)


def _previous_answer(monkeypatch):
    from niqki_tpu_torch.index import SketchIndex
    orig = SketchIndex.pretty_hits_batch
    last = {}

    def stale(self, q, headers):
        out = last.get("buf") or orig(self, q, headers)
        last["buf"] = orig(self, q, headers)
        return out
    monkeypatch.setattr(SketchIndex, "pretty_hits_batch", stale)


def _ingest_nothing(monkeypatch):
    from niqki_tpu_torch import engine
    monkeypatch.setattr(engine, "insert_file_lines", lambda idx, path: None)


def _ingest_half(monkeypatch):
    from niqki_tpu_torch import engine
    from niqki_tpu_torch.io.fasta import read_records

    def half(idx, path):
        recs = list(read_records(path, idx.params.K))
        for h, s in recs[:len(recs) // 2]:
            idx.insert_sketch(idx.sketch_records([s]), h)
    monkeypatch.setattr(engine, "insert_file_lines", half)


FAULTS = [
    ("synth100k_s12.query", _k2_one_less),
    ("synth100k_s12.query", _hits_half_batch),
    ("synth100k_s12.query", _fof_writes_nothing),
    ("synth100k_s12.lookup", _k2_one_less),
    ("synth100k_s12.lookup", _previous_answer),
    ("synth100k_s12.ingest", _k2_one_less),
    ("synth100k_s12.ingest", _ingest_half),
    ("synth100k_s12.ingest", _ingest_nothing),
]


def _run(cell, seconds=4.0):
    torch.set_num_threads(4)
    cfg, traffic = cell_parts(cell)
    return harness.run(cell, 2**31 + 99, seconds, False, device="cpu",
                       config=cfg, traffic=traffic)


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["synth100k_s12.query",
                                  "synth100k_s12.lookup",
                                  "synth100k_s12.ingest"])
def test_the_sound_program_is_correct(cell):
    res = _run(cell)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
