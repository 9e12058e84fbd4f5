"""Nothing the benchmark runs loads JAX or the JAX package: module names
are compared by their whole top-level name, so the port (whose name
begins with the JAX package's) passes."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "niqki_tpu"}

LOAD_ALL = r"""
import importlib, json, sys
from benchmark import harness, control
spec = harness.load_spec()
for c in spec["workloads"]:
    harness.load_json("configs", c["config"])
    t = harness.load_json("traffic", c["traffic"])
    importlib.import_module("benchmark.loops." + t["loop"])
for m in spec["per_layer"]:
    harness.metric_module(m["name"])
from benchmark import spans
p = spans.Probes(); spans.label_program(p); p.restore()
import niqki_tpu_torch.engine, niqki_tpu_torch.index
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""


def test_the_harness_loads_no_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "niqki_tpu_torch" in top and "benchmark" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files():
    for d, _, names in os.walk(BENCH):
        for n in names:
            if n.endswith(".py") and "tests" not in d.split(os.sep):
                yield os.path.join(d, n)


def test_no_file_of_the_harness_names_jax_or_the_smoke_tools():
    for path in _files():
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            assert top not in FORBIDDEN | {"chip_smoke", "tools", "bench",
                                           "bench_scale", "bench_reads"}, \
                (path, mod)


def test_the_reference_imports_torch_and_numpy_only():
    mods = {m.split(".", 1)[0]
            for m in _imports(os.path.join(BENCH, "reference.py"))}
    assert mods <= {"__future__", "numpy", "torch"}, mods
