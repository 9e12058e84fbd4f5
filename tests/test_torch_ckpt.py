"""The port's sharded checkpoints (v2 row blocks, v3 with bit-planes, v1
npz read) against niqki_tpu's, and the host plane pack and O_DIRECT IO
behind them. Tolerance 0: files are compared byte for byte (``.gz`` shards
decompressed), matrices and planes as integers.
"""

import dataclasses
import gzip
import json
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import cli as jcli
from niqki_tpu import native
from niqki_tpu.ops import bcount as jbcount
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu_torch import SketchIndex, cli, hostmem
from niqki_tpu_torch import native as tnative
from niqki_tpu_torch.ops import bcount

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FOF = f"{FIXDIR}/fof_tiny.txt"


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _jax_index(G=70, seed=5, lF=12, stale=False):
    """A niqki_tpu index of G random rows with empty (-1) slots; ``stale``
    gives it -G stale fingerprint constants."""
    rng = np.random.default_rng(seed)
    p = JaxParams(lF=lF, K=21, min_fract=0.05)
    if stale:
        p = p.with_best_H(1e9)
        assert p.stale_mask_M is not None
    idx = JaxIndex(p)
    for i in range(G):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        sk[rng.choice(p.F, 11, replace=False)] = -1
        idx.insert_sketch(sk, f"g{i} {'x' * (i % 3)}")
    return idx


def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    return zlib.decompress(data, 31) if path.endswith(".gz") else data


def _assert_same_files(da, db):
    """Two checkpoint directories hold the same files with the same bytes
    (``.gz`` shards decompressed; the manifest also as parsed JSON)."""
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for name in os.listdir(da):
        assert _read(os.path.join(da, name)) == \
            _read(os.path.join(db, name)), name
    with open(os.path.join(da, "manifest.json")) as fa, \
            open(os.path.join(db, "manifest.json")) as fb:
        assert json.load(fa) == json.load(fb)


# ---------------------------------------------------------------------------
# the host plane pack

@pytest.mark.parametrize("N,F,W", [(130, 4096, 12), (64, 1024, 7),
                                   (37, 2048, 30)])
def test_np_pack_bitplanes_matches_every_pack(N, F, W):
    """The native pack (in odd row chunks), its numpy twin, the port's
    device-side pack_bitplanes(query=False) on the CPU, and niqki_tpu's
    np_pack_bitplanes and jax pack_bitplanes give the same bits; the native
    pack also fills a row slice of larger planes and nothing around it."""
    rng = np.random.default_rng(N + W)
    m = rng.integers(-3, 1 << W, size=(N, F)).astype(np.int32)
    got = bcount.np_pack_bitplanes(m, W, row_chunk=50)
    assert got.dtype == np.uint32 and got.shape == (W + 1, N, F // 32)
    np.testing.assert_array_equal(bcount.np_pack_bitplanes_plain(m, W), got)
    dev = bcount.pack_bitplanes(torch.from_numpy(m), W=W, query=False)
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), got)
    np.testing.assert_array_equal(jbcount.np_pack_bitplanes(m, W), got)
    np.testing.assert_array_equal(np.asarray(jbcount.pack_bitplanes(
        jnp.asarray(m), W=W, query=False)), got)
    big = np.zeros((W + 1, N + 40, F // 32), np.uint32)
    out = bcount.np_pack_bitplanes(m, W, out=big[:, 9:9 + N], row_chunk=16)
    assert out.base is big or out.base is big.base
    np.testing.assert_array_equal(big[:, 9:9 + N], got)
    assert not big[:, :9].any() and not big[:, 9 + N:].any()


def test_np_pack_bitplanes_never_falls_back(monkeypatch):
    """No silent numpy pack: a layout the native pack refuses, and a
    missing native library, raise."""
    m = np.zeros((8, 1024), np.int32)
    with pytest.raises(ValueError, match="refuses"):
        bcount.np_pack_bitplanes(m, 12, out=np.zeros((13, 8, 32), np.int32))
    with pytest.raises(ValueError, match="refuses"):
        bcount.np_pack_bitplanes(m, 12, out=np.zeros((13, 32, 8),
                                                     np.uint32).swapaxes(1, 2))
    with pytest.raises(ValueError, match="refuses"):
        bcount.np_pack_bitplanes(m, 31)
    with pytest.raises(ValueError, match="F % 32"):
        bcount.np_pack_bitplanes(np.zeros((2, 48), np.int32), 12)
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="not loaded"):
        bcount.np_pack_bitplanes(m, 12)


# ---------------------------------------------------------------------------
# O_DIRECT IO

@pytest.mark.parametrize("source", ["big_empty", "torch", "odd_size"])
def test_write_read_direct_roundtrip(tmp_path, source):
    """write_direct/read_direct give plain write/read bytes, from a
    hugepage buffer (aligned bulk), an array handed over from torch
    (unaligned: buffered) and a size that is no multiple of 4096 (the
    buffered tail); a ranged read takes the bytes from its offset."""
    n = 3 << 20
    if source == "big_empty":
        arr = hostmem.big_empty((n // 4,), np.int32)
        arr[:] = np.arange(n // 4, dtype=np.int32)
    elif source == "torch":
        arr = torch.arange(n // 4 + 3, dtype=torch.int32)[3:].numpy()
    else:
        arr = np.arange(n // 4 + 1001, dtype=np.int32)
    path = str(tmp_path / "a.bin")
    hostmem.write_direct(path, arr)
    with open(path, "rb") as f:
        assert f.read() == arr.tobytes()
    back = hostmem.big_empty(arr.shape, np.int32)
    hostmem.read_direct(path, back)
    np.testing.assert_array_equal(back, arr)
    part = np.empty(1024, np.int32)
    hostmem.read_direct(path, part, offset=8192)
    np.testing.assert_array_equal(part, arr[2048:3072])


def test_read_direct_raises_on_short_file(tmp_path):
    path = str(tmp_path / "short.bin")
    hostmem.write_direct(path, np.arange(5000, dtype=np.int32))
    with pytest.raises(OSError, match="short read"):
        hostmem.read_direct(path, hostmem.big_empty((1 << 20,), np.int32))
    with pytest.raises(ValueError, match="C-contiguous"):
        hostmem.read_direct(path, np.zeros((4, 8), np.int32)[:, ::2])


# ---------------------------------------------------------------------------
# checkpoints against niqki_tpu's

@pytest.mark.parametrize("compress,planes,shards,stale", [
    (True, False, 1, False), (True, False, 3, True),
    (False, False, 1, True), (False, False, 3, False),
    (False, True, 1, False), (False, True, 3, True),
    (True, True, 1, True), (True, True, 3, False)])
def test_save_sharded_matches_jax(tmp_path, compress, planes, shards, stale):
    """The port's checkpoint of an index carried over from niqki_tpu is
    file for file niqki_tpu's: v2 and v3, compressed and raw, 1 and 3
    shards, with and without -G stale constants."""
    jidx = _jax_index(stale=stale)
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jidx.save_sharded(dj, num_shards=shards, compress=compress, planes=planes)
    SketchIndex.from_jax(jidx, device="cpu").save_sharded(
        dt, num_shards=shards, compress=compress, planes=planes)
    _assert_same_files(dj, dt)
    with open(os.path.join(dt, "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == ("niqki_tpu.sharded.v3" if planes
                             else "niqki_tpu.sharded.v2")
    assert len(man["shards"]) == shards
    assert all(("planes" in sh) == planes for sh in man["shards"])


def _assert_same_index(tidx, jidx):
    assert dataclasses.asdict(tidx.params) == dataclasses.asdict(jidx.params)
    assert tidx.names == jidx.names
    np.testing.assert_array_equal(tidx.matrix(), jidx.matrix())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("compress,planes", [(True, False), (False, True)])
def test_each_package_loads_the_others(tmp_path, writer, compress, planes):
    """A checkpoint written by either package loads in both, with equal
    matrix, names and params (the float min_fract and the -G stale
    constants included)."""
    jidx = _jax_index(G=41, seed=9, stale=True)
    ck = str(tmp_path / "ck")
    src = jidx if writer == "jax" else SketchIndex.from_jax(jidx,
                                                            device="cpu")
    src.save_sharded(ck, num_shards=3, compress=compress, planes=planes)
    tidx = SketchIndex.load_sharded(ck, device="cpu")
    jback = JaxIndex.load_sharded(ck)
    _assert_same_index(tidx, jidx)
    _assert_same_index(tidx, jback)
    assert tidx.params.min_fract == 0.05
    assert (tidx.params.mask_M, tidx.params.maximal_remainder) == \
        (jidx.params.mask_M, jidx.params.maximal_remainder)


def test_load_sharded_reads_v1_npz(tmp_path):
    """A legacy v1 checkpoint (npz shards of sketches and names) loads as
    niqki_tpu loads it."""
    jidx = _jax_index(G=10, seed=3)
    mat, p = jidx.matrix(), jidx.params
    ck = tmp_path / "v1"
    ck.mkdir()
    shards = []
    for s, (lo, hi) in enumerate([(0, 4), (4, 10)]):
        fn = f"shard_{s:05d}.npz"
        np.savez(ck / fn, sketches=mat[lo:hi],
                 names=np.array(jidx.names[lo:hi], dtype=object))
        shards.append({"file": fn, "lo": lo, "hi": hi})
    (ck / "manifest.json").write_text(json.dumps({
        "format": "niqki_tpu.sharded.v1",
        "params": {"lF": p.lF, "K": p.K, "W": p.W, "H": p.H,
                   "min_fract": p.min_fract},
        "genomes": 10, "shards": shards}))
    tidx = SketchIndex.load_sharded(str(ck), device="cpu")
    _assert_same_index(tidx, JaxIndex.load_sharded(str(ck)))
    _assert_same_index(tidx, jidx)


def test_load_sharded_refuses_unknown_format(tmp_path):
    ck = str(tmp_path / "ck")
    SketchIndex.from_jax(_jax_index(G=3), device="cpu").save_sharded(ck)
    with open(os.path.join(ck, "manifest.json")) as f:
        man = json.load(f)
    man["format"] = "niqki_tpu.sharded.v9"
    with open(os.path.join(ck, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        SketchIndex.load_sharded(ck, device="cpu")


@pytest.mark.parametrize("G,shards", [(2, 3), (0, 1), (1, 2)])
def test_empty_shards(tmp_path, G, shards):
    """Shards with no rows (hi == lo) write an empty name blob and load to
    no names, as niqki_tpu's; so does an empty index."""
    jidx = _jax_index(G=G, seed=4)
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jidx.save_sharded(dj, num_shards=shards, compress=False, planes=True)
    SketchIndex.from_jax(jidx, device="cpu").save_sharded(
        dt, num_shards=shards, compress=False, planes=True)
    _assert_same_files(dj, dt)
    assert os.path.getsize(os.path.join(dt, "shard_00000.names")) == 0
    tidx = SketchIndex.load_sharded(dt, device="cpu")
    assert tidx.G == G
    _assert_same_index(tidx, JaxIndex.load_sharded(dj))


@pytest.mark.parametrize("mode", ["bcount", "xla", "mxu"])
def test_reloaded_index_counts(tmp_path, monkeypatch, mode):
    """load_sharded leaves the host matrix with every device copy empty;
    the first count builds them, and counts equal the saved index's and
    niqki_tpu's."""
    jidx = _jax_index(G=33, seed=8)
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    ck = str(tmp_path / "ck")
    tidx.save_sharded(ck, num_shards=2, compress=False, planes=True)
    back = SketchIndex.load_sharded(ck, device="cpu")
    assert back.device.type == "cpu" and back._mat is not None
    assert (back._device_mat, back._device_packed, back._device_planes) == \
        (None, None, None)
    q = jidx.matrix()[:5].copy()
    q[1, ::7] = -3
    monkeypatch.setenv("NIQKI_TPU_COUNT", mode)
    got = back.counts(q)
    np.testing.assert_array_equal(got, tidx.counts(q))
    monkeypatch.setenv("NIQKI_TPU_COUNT", "xla")
    np.testing.assert_array_equal(got, jidx.counts(q))
    assert (back._device_planes is not None) == (mode == "bcount")


def test_cli_roundtrip_matches_jax(tmp_path, monkeypatch, capsys):
    """-I fof_tiny -S 10 --save-sharded ck --shards 3, then --load-sharded
    ck -Q <fof>, through both CLIs: the same checkpoint files and the same
    hit bytes; -M on a loaded checkpoint re-inserts its fof as niqki_tpu's
    does."""
    monkeypatch.chdir(tmp_path)
    qfof = tmp_path / "q.txt"
    qfof.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                            ("tiny2.fa", "multi.fa", "tiny1.fa")))
    base = ["-I", FOF, "-S", "10", "-K", "21", "-J", "0.05", "--shards", "3"]
    assert jcli.main(base + ["--save-sharded", "cj", "-O", "sj.gz"]) == 0
    assert cli.main(base + ["--save-sharded", "ct", "-O", "st.gz",
                            "--device", "cpu"]) == 0
    _assert_same_files("cj", "ct")
    assert _gz("st.gz") == _gz("sj.gz") == b""
    assert jcli.main(["--load-sharded", "cj", "-Q", str(qfof),
                      "-O", "qj.gz"]) == 0
    assert cli.main(["--load-sharded", "ct", "-Q", str(qfof), "-O", "qt.gz",
                     "--device", "cpu"]) == 0
    assert _gz("qt.gz") == _gz("qj.gz")
    assert b"tiny2.fa:1 " in _gz("qt.gz")
    assert jcli.main(["--load-sharded", "cj", "-M", FOF, "-O", "mj.gz"]) == 0
    assert cli.main(["--load-sharded", "ct", "-M", FOF, "-O", "mt.gz",
                     "--device", "cpu"]) == 0
    assert _gz("mt.gz") == _gz("mj.gz")
    assert _gz("mt.gz").count(b"\n") == 7          # 6 genomes + header
    assert "Number of indexed genomes" in capsys.readouterr().out
