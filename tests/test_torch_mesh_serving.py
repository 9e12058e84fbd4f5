"""The port's mesh serving (parallel.serving.ShardedIndex and the
SketchIndex/engine hooks) against niqki_tpu's at 2x4: counts, sparse hits
and the mesh -M sweep on eight virtual CPU devices (NIQKI_TPU_VIRTUAL_DEVICES
for the port, tests/conftest.py's XLA devices for niqki_tpu, Pallas in
interpret mode). Tolerance 0: counts and output bytes are compared
exactly.
"""

import gzip
import os

import jax
import numpy as np
import pytest
import torch

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import native, oracle as joracle
from niqki_tpu.ops import bcount as jbcount
from niqki_tpu.ops import pcount as jpcount
from niqki_tpu.ops.densify import densify_device as jdensify
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu.parallel import auto as jauto
from niqki_tpu.parallel import mesh as jmesh
from niqki_tpu.parallel import sharded as jsh
from niqki_tpu.parallel.serving import ShardedIndex as JShardedIndex
from niqki_tpu_torch import SketchIndex, SketchParams
from niqki_tpu_torch import native as tnative
from niqki_tpu_torch.ops import bcount, pcount
from niqki_tpu_torch.ops.densify import densify_device
from niqki_tpu_torch.parallel import auto, mesh as tmesh, sharded as tsh
from niqki_tpu_torch.parallel.serving import ShardedIndex

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

INT32_MAX = np.iinfo(np.int32).max
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def virtual_devices(monkeypatch):
    monkeypatch.setenv("NIQKI_TPU_VIRTUAL_DEVICES", "8")
    monkeypatch.delenv("NIQKI_TPU_MESH", raising=False)


@pytest.fixture(scope="module")
def jm():
    assert len(jax.devices()) == 8
    return jmesh.make_mesh(dp=2, tp=4)


@pytest.fixture
def tm():
    return tmesh.make_mesh(tmesh.device_list("cpu"), dp=2, tp=4)


def _tparams(jp):
    return SketchParams(lF=jp.lF, K=jp.K, W=jp.W, H=jp.H,
                        min_fract=jp.min_fract)


# ---------------------------------------------------------------------------
# ShardedIndex, the SketchIndex hooks and checkpoints

def _index_with_clusters(G, p, seed):
    """niqki_tpu's test index: every 3rd row a near-copy of one base (a tie
    cluster of real hits), the rest random."""
    rng = np.random.default_rng(seed)
    idx = JaxIndex(p)
    base = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
    for i in range(G):
        if i % 3 == 0:
            sk = base.copy()
            sk[: i % 7] = (base[: i % 7] + 1) % p.fingerprint_range
        else:
            sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        idx.insert_sketch(sk, f"g{i}")
    return idx


def _queries(mat):
    q = mat[:5].copy()
    q[2, ::9] = -3
    q[3, ::7] = -1
    return q


@pytest.mark.parametrize("G,lF", [(11, 12), (11, 10), (9, 5)])
def test_sharded_index_counts_match_jax(jm, tm, G, lF):
    """G not a multiple of tp; lF=12 the planes route, lF=10 packed, lF=5
    dense (F % 256 fails), as niqki_tpu's interpret-mode choice."""
    p = JaxParams(lF=lF, K=21, min_fract=0.05)
    jidx = _index_with_clusters(G, p, G)
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    js, ts = JShardedIndex(jidx, jm), ShardedIndex(tidx, tm)
    assert ts._kernel == js._kernel == {12: "planes", 10: "packed",
                                        5: "dense"}[lF]
    assert ts._Gp == js._Gp
    q = _queries(jidx.matrix())
    np.testing.assert_array_equal(ts.counts(q), js.counts(q))
    assert ts.hits(q[0]) == js.hits(q[0])


def test_sharded_index_topk_and_selfjoin_none_off_planes(tm, monkeypatch):
    """The two places where the mesh hands back to the single-device path,
    as niqki_tpu's: topk_counts at min_score < 1, selfjoin_block off the
    planes route."""
    p = SketchParams(lF=10, K=21, min_fract=0.05)
    idx = SketchIndex.from_jax(_index_with_clusters(20, JaxParams(
        lF=10, K=21, min_fract=0.05), 2), device="cpu")
    packed = ShardedIndex(idx, tm)
    assert packed._kernel == "packed"
    assert packed.selfjoin_block(0, 96, 8, 1) is None
    assert packed.topk_counts(idx.matrix()[:2], 8, 1) is None
    p12 = JaxParams(lF=12, K=21)
    idx12 = SketchIndex.from_jax(_index_with_clusters(20, p12, 2),
                                 device="cpu")
    planes = ShardedIndex(idx12, tm)
    assert planes._kernel == "planes"
    assert planes.topk_counts(idx12.matrix()[:2], 8, 0) is None
    assert planes.topk_counts(idx12.matrix()[:2], 8, 1) is not None
    # the index-level fallbacks: None from pretty_hits_batch, dense counts
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    assert idx.pretty_hits_batch(idx.matrix()[:2], ["a", "b"]) is None
    assert p.min_score > 0
    with pytest.raises(ValueError, match="shape gate"):
        ShardedIndex(idx, tm, kernel="planes")


def _jax_matrix(jidx, tmp_path, name):
    from niqki_tpu import engine as jengine
    from niqki_tpu.io.writers import GzTextWriter as JW
    path = tmp_path / name
    with JW(str(path)) as out:
        jengine.query_matrix(jidx, out)
    return gzip.open(path).read()


def _torch_matrix(tidx, tmp_path, name):
    from niqki_tpu_torch import engine
    from niqki_tpu_torch.io.writers import GzTextWriter
    path = tmp_path / name
    with GzTextWriter(str(path)) as out:
        engine.query_matrix(tidx, out)
    return gzip.open(path).read()


@pytest.mark.parametrize("G,cap,jax_mesh", [(48, "8", True),
                                             (48, "2048", False),
                                             (40, "4", False)])
def test_pretty_hits_batch_mesh_matches_jax(monkeypatch, G, cap, jax_mesh):
    """Per-shard top-k under 2x4 at G < 4096 (the mesh branch comes before
    the G gate); a cap of 4/8 forces the per-row dense re-fetch. The bytes
    equal niqki_tpu's, from its own 2x4 sparse path (jax_mesh) or from its
    single-device counts formatted densely (the others, which keep its
    interpret mode short)."""
    monkeypatch.setenv("NIQKI_TPU_HITS_CAP", cap)
    p = JaxParams(lF=12, K=21, min_fract=0.05)
    jidx = _index_with_clusters(G, p, 3)
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    q = _queries(jidx.matrix())
    headers = [f"q{i}" for i in range(len(q))]
    if not jax_mesh:
        want = native.HitsFormatter(jidx.names, p.F, p.min_score).format(
            jidx.counts(q), headers)
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    if jax_mesh:
        want = jidx.pretty_hits_batch(q, headers)
    got = tidx.pretty_hits_batch(q, headers)
    assert want is not None and got == want
    assert tidx._sharded is not None and tidx._sharded._kernel == "planes"
    fmt = tnative.HitsFormatter(tidx.names, p.F, p.min_score)
    assert got == fmt.format(tidx.counts(q), headers)
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    assert fmt.format(tidx.counts(q), headers) == got
    if cap != "2048":                            # q0's row passes the cap
        assert got.split(b"\n")[0].count(b":") > int(cap)


@pytest.mark.parametrize("cap,mf", [("4", 0.05), ("1024", 0.05),
                                    ("1024", 0.0)])
def test_matrix_selfjoin_mesh_matches_jax(monkeypatch, tmp_path, cap, mf):
    """The mesh's full self-join sweep: bytes == niqki_tpu's == the port's
    single-device dense loop; cap 4 re-fetches blocks dense (held against
    niqki_tpu's own 2x4 sweep), min_score 0 ships dense rows (held, with
    cap 1024, against niqki_tpu's dense loop, which keeps its interpret
    mode short). NIQKI_TPU_MATRIX_SYM=on does not take the port off the
    mesh sweep."""
    from niqki_tpu_torch import engine
    p = JaxParams(lF=12, K=21, min_fract=mf)
    jidx = _index_with_clusters(40, p, 7)
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    single = _torch_matrix(SketchIndex.from_jax(jidx, device="cpu"),
                           tmp_path, "one.gz")
    if cap != "4":
        want = _jax_matrix(jidx, tmp_path, "j.gz")
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", cap)
    monkeypatch.setenv("NIQKI_TPU_MATRIX_SYM", "on")
    if cap == "4":
        want = _jax_matrix(jidx, tmp_path, "j.gz")
    calls = []
    orig = engine._query_matrix_selfjoin_mesh
    monkeypatch.setattr(engine, "_query_matrix_selfjoin_mesh",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(engine, "_query_matrix_selfjoin_sym",
                        lambda *a: pytest.fail("symmetric sweep on a mesh"))
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    got = _torch_matrix(tidx, tmp_path, "t.gz")
    assert calls == [1] and got == want == single
    assert tidx._sharded._kernel == "planes"


def test_mesh_flip_rebuilds_sharded(monkeypatch):
    """Flipping NIQKI_TPU_MESH between counts calls rebuilds the sharded
    layout and keeps the counts."""
    rng = np.random.default_rng(0)
    p = SketchParams(lF=6)
    idx = SketchIndex(p, device="cpu")
    for g in range(16):
        idx.insert_sketch(rng.integers(0, p.fingerprint_range, p.F).astype(
            np.int32), f"g{g}")
    q = rng.integers(0, p.fingerprint_range, (4, p.F)).astype(np.int32)
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    c1 = idx.counts(q)
    s1 = idx._sharded
    assert s1 is not None and s1.mesh.shape == {"dp": 2, "tp": 4}
    assert idx.counts(q) is not None and idx._sharded is s1   # reused
    monkeypatch.setenv("NIQKI_TPU_MESH", "4x2")
    c2 = idx.counts(q)
    assert idx._sharded is not s1
    assert idx._sharded.mesh.shape == {"dp": 4, "tp": 2}
    np.testing.assert_array_equal(c1, c2)
    idx.insert_sketch(q[0], "new")                 # G changes: rebuilt
    s2 = idx._sharded
    c3 = idx.counts(q)
    assert idx._sharded is not s2 and c3.shape == (4, 17)
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    np.testing.assert_array_equal(c3, idx.counts(q))


def test_mesh_sketch_dispatch_matches_single_device(monkeypatch):
    """sketch_files and lines-mode records on the mesh (the batch split
    over all 8 devices, K1's plain version per device) == without."""
    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    paths = [f"{fix}/tiny{i}.fa" for i in (1, 2, 3)] + [f"{fix}/multi.fa"]
    p = SketchParams(lF=10, K=21)
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    from niqki_tpu_torch.ops import sketch
    sizes = []
    orig = sketch._batch_core
    monkeypatch.setattr(sketch, "_batch_core",
                        lambda w, *a, **k: sizes.append(len(w))
                        or orig(w, *a, **k))
    on = SketchIndex(p, device="cpu").sketch_files(paths)
    assert sizes and len(sizes) % 8 == 0 and len(set(sizes)) == 1
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    off = SketchIndex(p, device="cpu").sketch_files(paths)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
