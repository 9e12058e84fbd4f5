"""The matrix cell (``bact32k_s15.matrix``, ``loops/matrix.py``) run whole
through ``harness.run`` on the CPU at a small size: 512 sketch rows at
S=12 in 4 clusters of 128, ancestors of 60 kb, every row checked. The
port's symmetric sweep takes an index of 2,048 rows or more by itself;
here the environment sends the 512 rows there, in blocks of 160, so that
the run has several blocks, mirrors and windows. A sound run is correct;
a dropped mirror entry and a row written out of order are not; the
control (the reference one bit narrower) fails the check and the
reference itself passes it; a traced run reads the program's spans, and
a program without them reads nothing.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness

CELL = "bact32k_s15.matrix"
SEED = 2**33 + 171


def _parts():
    cfg = copy.deepcopy(harness.load_json("configs", "bact32k_s15"))
    cfg["params"]["S"] = 12
    cfg["genomes"].update(G=512, clusters=4, length=60000)
    traffic = dict(harness.load_json("traffic", "matrix"), check_rows=512)
    return cfg, traffic


@pytest.fixture(autouse=True)
def small_sweep(monkeypatch):
    torch.set_num_threads(4)
    for k, v in {"NIQKI_TPU_MATRIX": "selfjoin",
                 "NIQKI_TPU_MATRIX_BLOCK": "160",
                 "NIQKI_TPU_MATRIX_QB": "2"}.items():
        monkeypatch.setenv(k, v)


def _run(trace=False):
    cfg, traffic = _parts()
    return harness.run(CELL, SEED, 0.5, trace, device="cpu", config=cfg,
                       traffic=traffic)


def test_the_sound_program_is_correct(monkeypatch):
    from niqki_tpu_torch import engine
    sweeps = []
    orig = engine._query_matrix_selfjoin_sym
    monkeypatch.setattr(engine, "_query_matrix_selfjoin_sym",
                        lambda idx, out: sweeps.append(orig(idx, out))
                        or sweeps[-1])
    res = _run()
    assert res["correct"] is True, res["checks"]
    assert {c["value"] for c in res["checks"].values()} == {0}
    assert res["attempted"] >= 512 and res["failed"] == 0
    assert res["metrics"]["query_genomes_per_s"]["value"] > 0
    assert sweeps and all(s["N"] == 4 and s["mirror_entries"] > 0
                          and s["refetch"] == 0 for s in sweeps)


def _drop_a_mirror(monkeypatch):
    """Each block's first mirror entry is lost."""
    from niqki_tpu_torch import engine
    orig = engine._Mirrors.add

    def add(self, rows, cols, vals, lo):
        sel = np.nonzero(cols >= lo + self.B)[0]
        if len(sel):
            keep = np.ones(len(cols), bool)
            keep[sel[0]] = False
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        return orig(self, rows, cols, vals, lo)
    monkeypatch.setattr(engine._Mirrors, "add", add)


def _row_out_of_order(monkeypatch):
    """Each block's second row is written before its first."""
    from niqki_tpu_torch import engine
    orig = engine._write_rows

    def swapped(out, fmt, pfmt, vals, idx, over, dense_rows, lo):
        pfmt.write_sparse(out, vals[1:2], idx[1:2], lo + 1)
        pfmt.write_sparse(out, vals[:1], idx[:1], lo)
        orig(out, fmt, pfmt, vals[2:], idx[2:], over[2:],
             {r - 2: d for r, d in dense_rows.items()}, lo + 2)
    monkeypatch.setattr(engine, "_write_rows", swapped)


@pytest.mark.parametrize("fault", [_drop_a_mirror, _row_out_of_order],
                         ids=["dropped_mirror", "row_out_of_order"])
def test_a_broken_sweep_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("bits", [1, 0])
def test_the_control(bits):
    cfg, traffic = _parts()
    got = harness.control_run(CELL, SEED, bits, device="cpu", config=cfg,
                              traffic=traffic)
    values = {k: c["value"] for k, c in got["checks"].items()}
    if bits:
        assert got["correct"] is False and values["sampled_rows_wrong"] > 0
    else:
        assert got["correct"] is True and set(values.values()) == {0}


def test_a_traced_run_reads_the_programs_spans():
    res = _run(trace=True)
    assert res["correct"] is True, res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("mirror_pct.matrix", "format_wait_pct.matrix",
                 "emit_wait_pct.matrix"):
        assert 0 <= m[name] < 100, (name, m)
    assert m["mirror_pct.matrix"] > 0
    assert m["device_idle_pct.matrix"] == 100.0     # no device on the CPU


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    from niqki_tpu_torch import debug
    orig = debug.span
    monkeypatch.setattr(debug, "span", lambda name, level=1: debug.NULL
                        if name in ("sweep.mirror", "matrix.format_wait")
                        else orig(name, level))
    from niqki_tpu_torch import engine
    monkeypatch.setattr(engine, "span", debug.span)
    res = _run(trace=True)
    assert "mirror_pct.matrix" not in res["metrics"]
    assert "format_wait_pct.matrix" not in res["metrics"]
    assert "emit_wait_pct.matrix" in res["metrics"]
