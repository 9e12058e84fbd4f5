"""BENCHMARK.json keeps to the benchmark's contract: names, keys, units,
bounds, the files each entry names, and what each cell reports."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 << 10
    with open(path) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert all(_line(w) for w in spec["command"])
    assert 1 <= spec["run_seconds"] <= 51
    n = 24                              # the check's time with 24 cells
    assert (2 + 14 * n) * (spec["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200


def test_entries(spec):
    for kind, keys in KEYS.items():
        names = [e["name"] for e in spec[kind]]
        assert len(names) == len(set(names))
        for e in spec[kind]:
            extra = {"workloads"} if kind in ("end_to_end",
                                               "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.match(e["name"]), e["name"]
    for c in spec["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
    cfgs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    assert cfgs == {w["config"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_reports_what_the_contract_asks(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in spec["workloads"]:
        own = [m for m in spec["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(own) >= 2
        layer = [m for m in spec["per_layer"]
                 if w["name"] in m["workloads"]]
        assert layer
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                     [w["name"]])
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
