"""The port's native bindings, gzip writer and library knobs against
niqki_tpu's, on the CPU: read_encoded_records, sketch_codes_cpu (with its
table min-merge), scan_dump_sizes, gzip_member, sketch_stage_bench,
GzTextWriter under NIQKI_TPU_GZLEVEL, and
NIQKI_TPU_NO_NATIVE / NIQKI_TPU_NO_NATIVE_BUILD (the loader's answer is
cached, so the knobs run in subprocesses or with the cache reset). Arrays
are compared exactly; gzip output is compared decompressed, since only
those bytes are the writer's contract.
"""

import gzip
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from niqki_tpu import cli as jcli
from niqki_tpu import native as jnative
from niqki_tpu import oracle as joracle
from niqki_tpu.io import fasta as jfasta
from niqki_tpu.io.writers import GzTextWriter as JaxWriter
from niqki_tpu_torch import cli, native
from niqki_tpu_torch.io.writers import GzTextWriter

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
INT32_MAX = np.iinfo(np.int32).max


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# bindings

@pytest.mark.parametrize("name,ftype,gz", [
    ("multi.fa", None, False), ("tiny.fq", None, False),
    ("tiny.fq", "Q", True), ("tiny2.fa", "A", True)])
def test_read_encoded_records_matches_jax(tmp_path, name, ftype, gz):
    """(header, eff_fwd, eff_rc) per record == niqki_tpu's binding and the
    Python reader + oracle encoding, plain and gzipped, with the type
    detected and forced."""
    path = os.path.join(FIXDIR, name)
    if gz:
        with open(path, "rb") as f, \
                gzip.open(tmp_path / f"{name}.gz", "wb") as g:
            g.write(f.read())
        path = str(tmp_path / f"{name}.gz")
    K = 21
    got = list(native.read_encoded_records(path, K, ftype))
    want = list(jnative.read_encoded_records(path, K, ftype))
    ref = [(h, *joracle.encode_record(s, K))
           for h, s in jfasta.read_records(path, K)]
    assert len(got) == len(want) == len(ref) > 0
    for (h, f, r), (jh, jf, jr), (_, of, orc) in zip(got, want, ref):
        assert h == jh and f.dtype == r.dtype == np.uint8
        for a, b, c in ((f, jf, of), (r, jr, orc)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    with pytest.raises(OSError):
        next(native.read_encoded_records(str(tmp_path / "none.fa"), K))


@pytest.mark.parametrize("lF,W,H,stale", [(10, 12, 4, None), (14, 16, 4, None),
                                          (12, 12, 4, 1e9)])
def test_sketch_codes_cpu_matches_jax(lF, W, H, stale):
    """The rolling host sketch == niqki_tpu's binding, with the -G stale
    constants passed through; a given table is min-merged in place (two
    records into one table == niqki_tpu's two calls)."""
    from niqki_tpu_torch.params import SketchParams
    p = SketchParams(lF=lF, W=W, H=H)
    if stale:
        p = p.with_best_H(stale)
    recs = list(native.read_encoded_records(
        os.path.join(FIXDIR, "multi.fa"), p.K))
    rng = np.random.default_rng(lF)
    f = rng.integers(0, 4, 40_000).astype(np.uint8)
    recs.append(("rand", f, (3 - f).astype(np.uint8)))
    kw = dict(mask_M=p.mask_M, max_rem=p.maximal_remainder)
    t = np.full(p.F, INT32_MAX, np.int32)
    jt = t.copy()
    for _, f, r in recs:
        one = native.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H, **kw)
        np.testing.assert_array_equal(
            one, jnative.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H, **kw))
        assert native.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H, table=t,
                                       **kw) is t
        jnative.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H, table=jt, **kw)
        assert (t <= one).all()
    np.testing.assert_array_equal(t, jt)
    if not stale:   # H-derived defaults == the explicit constants
        np.testing.assert_array_equal(
            native.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H),
            native.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H, **kw))
    with pytest.raises(ValueError):
        native.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H,
                                table=np.zeros(7, np.int32))
    with pytest.raises(ValueError, match="shapes"):
        native.sketch_codes_cpu(f, r[:-1], p.lF, p.K, p.W, p.H)


def test_scan_dump_sizes_matches_jax():
    """Bucket sizes of a [size][gids...] stream == niqki_tpu's, and a
    truncated stream raises in both."""
    rng = np.random.default_rng(3)
    sizes = rng.integers(0, 6, 500).astype(np.uint32)
    sizes[:7] = 0
    words = np.concatenate([np.concatenate(
        [[s], rng.integers(0, 1 << 20, s)]) for s in sizes]).astype(
            np.uint32)
    names = np.frombuffer(b"name0\nname1\n", np.uint32)
    got = native.scan_dump_sizes(np.concatenate([words, names]), len(sizes))
    np.testing.assert_array_equal(got, sizes)
    np.testing.assert_array_equal(
        got, jnative.scan_dump_sizes(np.concatenate([words, names]),
                                     len(sizes)))
    cut = words[:-1]
    assert sizes[-1] > 0
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="truncated"):
            mod.scan_dump_sizes(cut, len(sizes))


def _raw_members(raw):
    """The compressed bytes of each gzip member of ``raw``."""
    out = []
    while raw:
        d = zlib.decompressobj(31)
        d.decompress(raw)
        rest = d.unused_data
        out.append(raw[:len(raw) - len(rest)])
        raw = rest
    return out


def _text(n_bytes, seed=0):
    """Matrix-like row text: names, tabs and %g counts."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 40, n_bytes // 4)
    cells = np.where(vals < 30, "0", np.char.mod("%.6g", vals / 4096))
    rows = ["row%d\t" % i + "\t".join(cells[i * 64:(i + 1) * 64]) + "\t\n"
            for i in range(len(cells) // 64)]
    return "".join(rows).encode()


@pytest.mark.parametrize("level", [1, 6, 9])
def test_gzip_member_matches_jax(level):
    """One gzip member == niqki_tpu's for the same library and level, and
    inflates to the input (a memoryview and an empty input too); higher
    levels do not grow the output."""
    data = _text(1 << 20)
    got = native.gzip_member(data, level)
    assert got == jnative.gzip_member(data, level)
    assert zlib.decompress(got, 31) == data
    assert zlib.decompress(native.gzip_member(memoryview(data)[7:], level),
                           31) == data[7:]
    assert zlib.decompress(native.gzip_member(b"", level), 31) == b""
    assert len(native.gzip_member(data, 9)) <= len(
        native.gzip_member(data, 1))


def test_gzip_member_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.gzip_member(b"abc") is None


def test_sketch_stage_bench_keys():
    """Per-stage ns a window: niqki_tpu's keys, positive stage times, and
    a record of K bases or fewer raises."""
    rec = next(native.read_packed_records(os.path.join(FIXDIR, "tiny1.fa"),
                                          31))
    _, words, n, _ = rec
    got = native.sketch_stage_bench(words, n, 10, 31, 12, 4, reps=2)
    want = jnative.sketch_stage_bench(words, n, 10, 31, 12, 4, reps=1)
    assert set(got) == set(want) == {"roll_ns", "roll_hash_ns", "full_ns",
                                     "scatter_ns", "hash_ns"}
    assert got["roll_ns"] > 0 and got["roll_hash_ns"] > 0 \
        and got["full_ns"] > 0
    assert got["hash_ns"] == got["roll_hash_ns"] - got["roll_ns"]
    assert got["scatter_ns"] == got["full_ns"] - got["roll_hash_ns"]
    with pytest.raises(ValueError, match="too short"):
        native.sketch_stage_bench(words[:2], 20, 10, 31, 12, 4)
    with pytest.raises(ValueError, match="packed words"):
        native.sketch_stage_bench(words[:1], 20, 10, 31, 12, 4)


# records a file, and the records that have no k-mers (in no batch)
_FINALIZE_LAYOUTS = {
    "one": ([1] * 6, ()),
    "merge": ([3, 2, 1], ()),
    "empty": ([2, 1, 0, 1], (0, 1)),
    "polyN": ([1, 2, 1], ()),
}


@pytest.mark.skipif(not native.available(),
                    reason="the port's native library is absent")
@pytest.mark.parametrize("layout,F,dtype", [
    (layout, 4096, dtype) for layout in _FINALIZE_LAYOUTS
    for dtype in (np.int16, np.int32)] + [
    ("merge", 32768, np.int16), ("empty", 32768, np.int32)])
def test_finalize_files_matches_the_loop(monkeypatch, layout, F, dtype):
    """native.finalize_files == index._finalize_loop, the Python loop, with
    native densify and with oracle.densify: one-record files, files of 2-3
    records whose min-merge order matters, a file whose records all lack
    k-mers (an empty sketch) and one of no records, int16 (-1 empty) and
    int32 (INT32_MAX empty) tables, and poly-N-like tables whose only
    fingerprint is 0 (densify's stuck-pass exit). Tables come in two
    batches, records out of order, with padding rows never read, the
    second batch not C-contiguous; a batch of another dtype or width, or
    of fewer rows than records, raises."""
    from niqki_tpu_torch import index
    from niqki_tpu_torch.params import SketchParams
    p = SketchParams(lF=F.bit_length() - 1)
    rec_counts, absent = _FINALIZE_LAYOUTS[layout]
    rng = np.random.default_rng(F + len(layout))
    R = sum(rec_counts)
    empty = -1 if dtype == np.int16 else INT32_MAX
    hi = 1 << (14 if dtype == np.int16 else 20)
    tables = rng.integers(0, hi, (R, F)).astype(dtype)
    tables[rng.random((R, F)) < 0.15] = empty
    if layout == "polyN":       # file 0 and the first record of file 1
        tables[:2] = empty
        tables[:2, 0] = 0
    present = rng.permutation([r for r in range(R) if r not in absent])
    hosts = []
    for chunk in np.array_split(present, 2):
        host = np.full((len(chunk) + 2, F), 7, dtype)   # 2 padding rows
        host[:len(chunk)] = tables[chunk]
        hosts.append((chunk.tolist(), host))
    hosts[1] = (hosts[1][0], np.asfortranarray(hosts[1][1]))
    got, threads = native.finalize_files(hosts, rec_counts, F, 4)
    assert threads == min(4, len(rec_counts))
    loop = index._finalize_loop(hosts, rec_counts, p)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = index._finalize_loop(hosts, rec_counts, p)
    assert len(got) == len(loop) == len(plain) == len(rec_counts)
    for g, a, b in zip(got, loop, plain):
        assert g.dtype == np.int32 and g.shape == (F,)
        assert np.array_equal(g, a) and np.array_equal(g, b)
    for i, cnt in enumerate(rec_counts):
        k = sum(rec_counts[:i])
        if not set(range(k, k + cnt)) - set(absent):
            assert (got[i] == -1).all()
    if layout == "polyN":
        assert (got[0] == -1).sum() == F - 1 and got[0][0] == 0
    if layout != "empty":
        assert (got[-1] != -1).all()
    chunk, host = hosts[0]
    for bad in (host.astype(np.int64), host[:, :-1], host[:len(chunk) - 1]):
        with pytest.raises(ValueError, match="tables of one dtype"):
            native.finalize_files([(chunk, bad)], rec_counts, F, 4)


# ---------------------------------------------------------------------------
# the writer

@pytest.mark.parametrize("env", [None, "1", "6", "9"])
def test_gz_writer_matches_jax(tmp_path, monkeypatch, env):
    """GzTextWriter at NIQKI_TPU_GZLEVEL (6 where unset): decompressed
    bytes == niqki_tpu's writer's over more than two 4 MiB members; the
    same library and level give the same 4 MiB members, and the port cuts
    the 1 MiB tail that niqki_tpu writes as one member into members of
    PIECE bytes, each byte-identical with niqki_tpu's member of its
    slice. The zlib route (no native library) does the same against
    niqki_tpu's zlib route."""
    if env:
        monkeypatch.setenv("NIQKI_TPU_GZLEVEL", env)
    level = int(env or 6)
    data = _text(9 << 20, seed=int(env or 0))
    tail, piece = data[2 * GzTextWriter.BLOCK:], GzTextWriter.PIECE
    cuts = range(0, len(tail), piece)
    paths = {}
    for tag, cls in (("port", GzTextWriter), ("jax", JaxWriter)):
        paths[tag] = str(tmp_path / f"{tag}.gz")
        with cls(paths[tag]) as w:
            for lo in range(0, len(data), 1 << 19):
                w.write(data[lo:lo + (1 << 19)])
    assert _gz(paths["port"]) == _gz(paths["jax"]) == data
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        port, jax = _raw_members(a.read()), _raw_members(b.read())
    assert len(jax) == 3 and port[:2] == jax[:2]
    assert [zlib.decompress(m, 31) for m in port[2:]] == [
        tail[lo:lo + piece] for lo in cuts]
    assert port[2:] == [JaxWriter._member(tail[lo:lo + piece], level)
                        for lo in cuts]
    monkeypatch.setattr(native, "gzip_member", lambda d, lv: None)
    monkeypatch.setattr(jnative, "available", lambda: False)
    with GzTextWriter(str(tmp_path / "z.gz")) as w:
        w.write(data)
    assert _gz(str(tmp_path / "z.gz")) == data
    with open(tmp_path / "z.gz", "rb") as f:
        z = _raw_members(f.read())
    assert z == [JaxWriter._member(data[lo:lo + GzTextWriter.BLOCK], level)
                 for lo in (0, GzTextWriter.BLOCK)] + [
        JaxWriter._member(tail[lo:lo + piece], level) for lo in cuts]


def test_gz_writer_levels_differ(tmp_path, monkeypatch):
    """NIQKI_TPU_GZLEVEL reaches the deflate: level 1 writes more bytes
    than 9."""
    data = _text(5 << 20, seed=1)
    size = {}
    for lv in (1, 9):
        monkeypatch.setenv("NIQKI_TPU_GZLEVEL", str(lv))
        with GzTextWriter(str(tmp_path / f"{lv}.gz")) as w:
            w.write(data)
        size[lv] = os.path.getsize(tmp_path / f"{lv}.gz")
        assert _gz(str(tmp_path / f"{lv}.gz")) == data
    assert size[1] > size[9]


# ---------------------------------------------------------------------------
# the loader's knobs

def test_no_native_knobs_in_process(monkeypatch):
    """NIQKI_TPU_NO_NATIVE=1 leaves the library unloaded (the answer is
    cached until _tried is reset); NIQKI_TPU_NO_NATIVE_BUILD=1 runs no
    make."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("NIQKI_TPU_NO_NATIVE", "1")
    assert not native.available()
    monkeypatch.delenv("NIQKI_TPU_NO_NATIVE")
    assert not native.available()                 # cached
    ran = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: ran.append(a))
    monkeypatch.setattr(native.os.path, "exists", lambda p: False)
    monkeypatch.setenv("NIQKI_TPU_NO_NATIVE_BUILD", "1")
    native._build()
    assert ran == []
    monkeypatch.delenv("NIQKI_TPU_NO_NATIVE_BUILD")
    native._build()
    assert len(ran) == 2                          # both make attempts


_PORT_NO_NATIVE = r"""
import gzip, os, sys
import numpy as np
from niqki_tpu_torch import SketchIndex, cli, native
from niqki_tpu_torch.params import SketchParams
fof, out, npz, ck = sys.argv[1:5]
assert cli.main(["-M", fof, "-S", "10", "-K", "21", "-J", "0.02",
                 "--device", "cpu", "-O", out]) == 0
d = np.load(npz)
p = SketchParams(lF=12, K=21, min_fract=0.05)
idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(len(d["m"]))],
                              d["m"], device="cpu")
idx.save_sharded(ck, num_shards=3, compress=False, planes=True)
back = SketchIndex.load_sharded(ck, device="cpu")
assert np.array_equal(back.matrix(), d["m"]) and back.names == idx.names
assert not native.available()
assert not any(m.split(".")[0] in ("jax", "niqki_tpu") for m in sys.modules)
print("OK")
"""

_JAX_NO_NATIVE = r"""
import sys
import numpy as np
from niqki_tpu import SketchIndex, native
from niqki_tpu.params import SketchParams
npz, ck = sys.argv[1:3]
d = np.load(npz)
idx = SketchIndex(SketchParams(lF=12, K=21, min_fract=0.05))
for i, row in enumerate(d["m"]):
    idx.insert_sketch(row, f"g{i}")
idx.save_sharded(ck, num_shards=3, compress=False, planes=True)
assert not native.available()
print("OK")
"""


def _run(script, args, cwd):
    env = dict(os.environ, NIQKI_TPU_NO_NATIVE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    res = subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout


def test_no_native_matrix_and_v3_save(tmp_path):
    """Under NIQKI_TPU_NO_NATIVE=1, in fresh processes: the port's -M of
    fof_tiny on the Python host paths (reader, densify, row writer) gives
    the bytes (decompressed) of its own -M with the library and of
    niqki_tpu's; and its v3 checkpoint (planes packed by numpy, as
    np_pack_bitplanes does where the library is absent) is file for file
    niqki_tpu's under the same setting, and reloads. The run is at S=10:
    the Python densify of fof_tiny's short genomes takes minutes a sketch
    at the golden fixture's S=16."""
    rng = np.random.default_rng(8)
    m = rng.integers(0, 1 << 12, (70, 4096)).astype(np.int32)
    m[rng.random(m.shape) < 0.01] = -1
    npz = str(tmp_path / "m.npz")
    np.savez(npz, m=m)
    out, ckt, ckj = (str(tmp_path / n) for n in ("m.gz", "ckt", "ckj"))
    _run(_PORT_NO_NATIVE, [os.path.join(FIXDIR, "fof_tiny.txt"), out, npz,
                           ckt], tmp_path)
    _run(_JAX_NO_NATIVE, [npz, ckj], tmp_path)
    flags = ["-M", os.path.join(FIXDIR, "fof_tiny.txt"), "-S", "10", "-K",
             "21", "-J", "0.02"]
    want = str(tmp_path / "want.gz")
    assert cli.main([*flags, "--device", "cpu", "-O", want]) == 0
    jout = str(tmp_path / "jax.gz")
    assert jcli.main([*flags, "-O", jout]) == 0
    assert _gz(out) == _gz(want) == _gz(jout)
    assert len(_gz(out).split(b"\n")) == 3 + 2
    assert sorted(os.listdir(ckt)) == sorted(os.listdir(ckj))
    assert any(n.startswith("planes_") for n in os.listdir(ckt))
    for name in os.listdir(ckt):
        with open(os.path.join(ckt, name), "rb") as a, \
                open(os.path.join(ckj, name), "rb") as b:
            if name == "manifest.json":
                assert json.load(a) == json.load(b)
            else:
                assert a.read() == b.read(), name
