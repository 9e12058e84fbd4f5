"""The port's slice as a whole: the -M all-vs-all matrix and the -I/-Q hit
query, byte for byte against the golden fixture and against niqki_tpu on
the same inputs (JAX on the CPU, Pallas in interpret mode; the port runs
its plain kernel versions). Output bytes must be identical: tolerance 0.
"""

import gzip
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import cli as jcli
from niqki_tpu import engine as jengine
from niqki_tpu import native
from niqki_tpu.io.writers import GzTextWriter
from niqki_tpu.params import SketchParams
from niqki_tpu_torch import SketchIndex, cli, engine, kernels

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["auto", "selfjoin"])
def test_cli_matrix_golden(tmp_path, monkeypatch, mode, capsys):
    """-M at S=16 reproduces the reference binary's output; under selfjoin
    through sketch -> K1 -> planes -> K2 -> uint16 wrap at G=3, F=65536."""
    monkeypatch.setenv("NIQKI_TPU_MATRIX", mode)
    out = tmp_path / "m.gz"
    rc = cli.main(["-M", f"{FIXDIR}/fof_tiny.txt", "-S", "16", "-K", "21",
                   "-O", str(out), "--device", "cpu"])
    assert rc == 0
    assert _gz(out) == _gz(f"{FIXDIR}/matrix_s16_tiny.gz")
    assert "Number of indexed genomes" in capsys.readouterr().out


def _clustered(p, G=300, seed=44):
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, p.fingerprint_range, (3, p.F)).astype(np.int32)
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    for i in range(G):
        m = rng.random(p.F) < 0.4     # clusters of 100 share 40% of slots
        mat[i, m] = anc[i // 100][m]
        if i % 7 == 0:
            mat[i, rng.choice(p.F, 13, replace=False)] = -1
    return mat


def _matrix_bytes(eng, idx, path):
    with GzTextWriter(str(path)) as out:
        eng.query_matrix(idx, out)
    return _gz(path)


@pytest.mark.parametrize("case", ["dense_j0", "sparse_overflow"])
def test_query_matrix_matches_jax(tmp_path, monkeypatch, case):
    """The self-join full sweep equals niqki_tpu's on a clustered index:
    J=0 takes the dense subpath (96-row blocks: one interpret kernel shape
    on the JAX side); J=0.05 with 128-row blocks and a top-k cap of 16
    (< cluster size 100) takes the per-BLOCK_Q overflow re-fetch."""
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_SYM", "off")
    fract, block = 0.0, "96"
    if case == "sparse_overflow":
        fract, block = 0.05, "128"
        monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", "16")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_BLOCK", block)
    p = SketchParams(lF=12, K=21, min_fract=fract)
    mat = _clustered(p)
    names = [f"g{i}" for i in range(len(mat))]
    jidx = JaxIndex(p)
    for n, row in zip(names, mat):
        jidx.insert_sketch(row, n)
    want = _matrix_bytes(jengine, jidx, tmp_path / "j.gz")
    kernels.reset_launches()
    got = _matrix_bytes(engine, SketchIndex.from_jax(jidx, device="cpu"),
                        tmp_path / "t.gz")
    assert got == want
    assert kernels.LAUNCHES == {"psort": 0, "bcount": 0,
                                "pcount": 0}               # plain on CPU
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    assert _matrix_bytes(jengine, jidx, tmp_path / "d.gz") == want


@pytest.mark.parametrize("minjac", ["0", "0.05"])
def test_cli_index_query_matches_jax(tmp_path, monkeypatch, minjac):
    """-I fof_tiny -Q <fof>: the same bytes as niqki_tpu's CLI."""
    monkeypatch.chdir(tmp_path)
    qfof = tmp_path / "q.txt"
    qfof.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                            ("tiny2.fa", "multi.fa", "tiny1.fa")))
    args = ["-I", f"{FIXDIR}/fof_tiny.txt", "-Q", str(qfof), "-S", "12",
            "-K", "21", "-J", minjac]
    assert jcli.main(args + ["-O", "j.gz"]) == 0
    assert cli.main(args + ["-O", "t.gz", "--device", "cpu"]) == 0
    assert _gz("t.gz") == _gz("j.gz")
    assert b"tiny2.fa:1 " in _gz("t.gz")


@pytest.mark.parametrize("flags", [
    ["-S", "12", "-K", "21", "-G", "1000000000"],     # -G: stale constants
    ["-S", "13", "-W", "10", "-H", "3", "-J", "0.3"],
    ["-S", "15", "-W", "16"]])                        # scatter-min sketch
def test_cli_matrix_matches_jax(tmp_path, monkeypatch, flags):
    """-M through both CLIs with the sketch flags: the same bytes."""
    monkeypatch.chdir(tmp_path)
    args = ["-M", f"{FIXDIR}/fof_tiny.txt", *flags]
    assert jcli.main(args + ["-O", "j.gz"]) == 0
    assert cli.main(args + ["-O", "t.gz", "--device", "cpu"]) == 0
    assert _gz("t.gz") == _gz("j.gz")


@pytest.mark.parametrize("flag", [["--mesh", "2x4"], ["--load-sharded"]])
def test_cli_refuses_unported_flags(flag, tmp_path, capsys, monkeypatch):
    """No flag is refused any more: --mesh 2x4 (eight virtual CPU devices)
    gives the golden -M bytes, those of the run without it and
    niqki_tpu's; --load-sharded runs -M on a loaded checkpoint."""
    if flag == ["--mesh", "2x4"]:
        monkeypatch.setenv("NIQKI_TPU_VIRTUAL_DEVICES", "8")
        args = ["-M", f"{FIXDIR}/fof_tiny.txt", "-S", "16", "-K", "21",
                "--device", "cpu"]
        out, one = str(tmp_path / "m.gz"), str(tmp_path / "one.gz")
        assert cli.main(args + [*flag, "-O", out]) == 0
        assert "not ported yet" not in capsys.readouterr().err
        assert cli.main(args + ["-O", one]) == 0
        assert _gz(out) == _gz(one) == _gz(f"{FIXDIR}/matrix_s16_tiny.gz")
        return
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "m.gz")
    assert cli.main(["-I", f"{FIXDIR}/fof_tiny.txt", "-S", "16", "-K", "21",
                     "--save-sharded", ck, "-O", out, "--device", "cpu"]) == 0
    assert cli.main(["--load-sharded", ck, "-M", f"{FIXDIR}/fof_tiny.txt",
                     "-O", out, "--device", "cpu"]) == 0
    assert "not ported yet" not in capsys.readouterr().err
    assert _gz(out).count(b"\n") == 7     # 3 loaded + 3 re-inserted + header


_BLOCK_JAX = r"""
import runpy
import sys
preloaded = "jax" in sys.modules

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, _NoJax())
fof, qfof, multi, d = sys.argv[1:5]

def run(args):                           # as `python -m niqki_tpu_torch.cli`
    sys.argv = ["niqki_tpu_torch.cli", *args, "--device", "cpu"]
    try:
        runpy.run_module("niqki_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code

run(["-M", fof, "-S", "16", "-K", "21", "-O", d + "/m.gz"])
import os
os.environ["NIQKI_TPU_VIRTUAL_DEVICES"] = "8"
run(["-M", fof, "-S", "16", "-K", "21", "--mesh", "2x4", "-O",
     d + "/mm.gz"])
del os.environ["NIQKI_TPU_VIRTUAL_DEVICES"]
run(["-I", fof, "-Q", qfof, "-S", "12", "-K", "21", "-J", "0.05",
     "-O", d + "/q.gz"])
run(["-S", "5", "-i", multi, "-l", multi, "-O", d + "/l.gz"])
run(["-I", fof, "-S", "8", "-W", "10", "-H", "3", "-D", d + "/d.bin",
     "-O", d + "/n.gz"])
run(["-L", d + "/d.bin", "-Q", qfof, "-O", d + "/lq.gz"])
run(["-I", fof, "-S", "10", "-K", "21", "-J", "0.05", "--save-sharded",
     d + "/ck", "--shards", "2", "--profile", d + "/tr", "-O", d + "/s.gz"])
run(["--load-sharded", d + "/ck", "-Q", qfof, "-O", d + "/sq.gz"])
import os
os.environ["NIQKI_TPU_COUNT"] = "mxu"
run(["--load-sharded", d + "/ck", "-Q", qfof, "-O", d + "/mq.gz"])
del os.environ["NIQKI_TPU_COUNT"]
import niqki_tpu_torch.downloader
import niqki_tpu_torch.entry
import niqki_tpu_torch.ops.mxucount
import niqki_tpu_torch.parallel.serving
bad = [m for m in sys.modules
       if m == "niqki_tpu" or m.startswith("niqki_tpu.")]
assert not bad, bad
if not preloaded:
    assert "jax" not in sys.modules
print("OK", preloaded)
"""


def test_matrix_runs_with_jax_blocked(tmp_path):
    """The port's -M (also under --mesh 2x4), -I/-Q, -i/-l, -D then -L/-Q,
    and --save-sharded (with --profile) then --load-sharded/-Q (also under
    NIQKI_TPU_COUNT=mxu) import nothing of jax or niqki_tpu: a fresh CPU process whose import
    system refuses jax runs them all to the golden bytes and to niqki_tpu's
    bytes, imports the downloader, the entry twins and the mesh serving,
    and ends with no niqki_tpu module loaded."""
    qfof = tmp_path / "q.txt"
    qfof.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                            ("tiny2.fa", "multi.fa", "tiny1.fa")))
    env = dict(os.environ, NIQKI_TPU_MATRIX="selfjoin",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    res = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX, f"{FIXDIR}/fof_tiny.txt",
         str(qfof), f"{FIXDIR}/multi.fa", str(tmp_path)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout
    assert _gz(tmp_path / "m.gz") == _gz(f"{FIXDIR}/matrix_s16_tiny.gz")
    assert _gz(tmp_path / "mm.gz") == _gz(f"{FIXDIR}/matrix_s16_tiny.gz")
    assert _gz(tmp_path / "l.gz") == _gz(f"{FIXDIR}/lines_fa_s5.gz")
    assert _gz(tmp_path / "d.bin") == _gz(f"{FIXDIR}/dump_tiny_s8w10h3.bin")
    jout = tmp_path / "j.gz"
    assert jcli.main(["-I", f"{FIXDIR}/fof_tiny.txt", "-Q", str(qfof),
                      "-S", "12", "-K", "21", "-J", "0.05",
                      "-O", str(jout)]) == 0
    assert _gz(tmp_path / "q.gz") == _gz(jout)
    assert jcli.main(["-I", f"{FIXDIR}/fof_tiny.txt", "-Q", str(qfof),
                      "-S", "8", "-W", "10", "-H", "3", "-O", str(jout)]) == 0
    assert _gz(tmp_path / "lq.gz") == _gz(jout)
    assert jcli.main(["-I", f"{FIXDIR}/fof_tiny.txt", "-Q", str(qfof),
                      "-S", "10", "-K", "21", "-J", "0.05",
                      "-O", str(jout)]) == 0
    assert _gz(tmp_path / "sq.gz") == _gz(jout)
    assert _gz(tmp_path / "mq.gz") == _gz(jout)
    assert len(list((tmp_path / "tr").glob("*.pt.trace.json"))) == 1
    assert (tmp_path / "ck" / "manifest.json").exists()


def _imported_modules(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def _port_sources():
    pkg = os.path.join(REPO, "niqki_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _outside_paths(path):
    """The paths outside niqki_tpu_torch/ that a source file names: a
    token with a '/' that is absolute (but for the system's /dev and
    /usr), climbs with '..', or starts at a directory or file of the
    repository's root other than the port's; and each '#include "..."'
    of a file not beside it."""
    here = os.path.dirname(path)
    roots = (set(os.listdir(REPO)) | {"build"}) - {"niqki_tpu_torch"}
    with open(path) as f:
        text = f.read()
    bad = [t for t in re.findall(r"[\w.+-]*(?:/[\w.+-]+)+/?", text)
           if t.startswith("/") and not t.startswith(("/dev/", "/usr/"))
           or ".." in t.split("/")
           or t.split("/")[0] in roots]
    bad += [inc for inc in re.findall(r'#include "([^"]+)"', text)
            if not os.path.isfile(os.path.join(here, inc))
            or os.path.dirname(inc)]
    return bad


def test_chip_smoke_imports_only_the_port():
    """No file of niqki_tpu_torch (recursively) nor chip_smoke.py imports
    jax or any module of the JAX package; the smoke reaches the host-native
    reference through the port. No file under niqki_tpu_torch/csrc/ (the
    native library's and the kernels' sources, the Makefile) names a path
    outside niqki_tpu_torch/, so the port builds from its own sources."""
    assert "niqki_tpu_torch" in set(_imported_modules(
        os.path.join(REPO, "chip_smoke.py")))
    bad = [(os.path.relpath(path, REPO), m)
           for path in _port_sources() for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "niqki_tpu")]
    assert not bad, bad
    sources = {os.path.relpath(path, REPO) for path in _port_sources()}
    assert {f"niqki_tpu_torch/{m}" for m in (
        "debug.py", "downloader.py", "ops/mxucount.py", "hostmem.py",
        "index.py", "cli.py", "entry.py", "ops/densify.py",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/auto.py",
        "parallel/sharded.py", "parallel/serving.py")} <= sources
    assert len(sources) > 10
    csrc = os.path.join(REPO, "niqki_tpu_torch", "csrc")
    names = sorted(os.listdir(csrc))
    assert {"Makefile", "host.cpp", "niqki_host.cpp"} <= set(names)
    bad = {n: _outside_paths(os.path.join(csrc, n)) for n in names}
    assert not any(bad.values()), bad


def test_entry_points_run_on_the_card_by_default(tmp_path, monkeypatch):
    """SketchIndex(params) and the CLI run on cuda unless asked for the
    CPU, and raise where torch sees no card instead of falling back."""
    from niqki_tpu_torch import SketchParams as TorchParams
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees no card"):
        SketchIndex(TorchParams(lF=12))
    args = ["-M", f"{FIXDIR}/fof_tiny.txt", "-S", "16", "-K", "21",
            "-O", str(tmp_path / "m.gz")]
    with pytest.raises(RuntimeError, match="sees no card"):
        cli.main(args)
    assert SketchIndex(TorchParams(lF=12), device="cpu").device.type == "cpu"
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert _gz(tmp_path / "m.gz") == _gz(f"{FIXDIR}/matrix_s16_tiny.gz")


def test_from_jax_carries_stale_params():
    """from_jax rebuilds the port's own SketchParams field by field,
    including the -G stale mask_M / maximal_remainder."""
    import dataclasses
    from niqki_tpu_torch import SketchParams as TorchParams
    p = SketchParams(lF=12, K=21, min_fract=0.1).with_best_H(1e9)
    assert p.stale_mask_M is not None and p.H == 5
    jidx = JaxIndex(p)
    jidx.insert_sketch(np.arange(p.F, dtype=np.int32) % p.fingerprint_range,
                       "g0")
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    assert type(tidx.params) is TorchParams
    assert dataclasses.asdict(tidx.params) == dataclasses.asdict(p)
    assert (tidx.params.mask_M, tidx.params.maximal_remainder) == \
        (p.mask_M, p.maximal_remainder)
    assert tidx.names == ["g0"]
    np.testing.assert_array_equal(tidx.matrix(), jidx.matrix())


def test_chip_smoke_host_reference_matches_port(monkeypatch):
    """The smoke's reference index (the port's SketchIndex under
    NIQKI_TPU_SKETCH=host: the native rolling sketcher) holds the same
    sketches as the port's device route."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    monkeypatch.delenv("NIQKI_TPU_SKETCH", raising=False)
    p = SketchParams(lF=16, K=21)
    host = chip_smoke.host_index(f"{FIXDIR}/fof_tiny.txt", p)
    assert "NIQKI_TPU_SKETCH" not in os.environ
    dev = SketchIndex(p, device="cpu")
    engine.insert_fof_whole(dev, f"{FIXDIR}/fof_tiny.txt")
    assert host.G == dev.G == 3 and host.names == dev.names
    np.testing.assert_array_equal(host.matrix(), dev.matrix())


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(tmp_path, where):
    """Without a CUDA device, or copied away from the repo, chip_smoke.py
    exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as f, open(tmp_path / "chip_smoke.py", "w") as g:
            g.write(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
