"""The port's mesh on its entry points against niqki_tpu's at 2x4: the CLI
under --mesh 2x4 (-M, -I/-Q, -i/-l), the mesh-direct restart from v2/v3
checkpoints written by either package, and the entry twins (entry,
dryrun_multichip). Eight virtual CPU devices on both sides
(NIQKI_TPU_VIRTUAL_DEVICES for the port, tests/conftest.py's for
niqki_tpu); output bytes are compared exactly (.gz decompressed).
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


def _save(idx, ck, kind):
    kw = {"v3": dict(compress=False, planes=True),
          "v2": dict(compress=False), "v2-gz": dict(compress=True)}[kind]
    idx.save_sharded(str(ck), num_shards=3, **kw)


@pytest.mark.parametrize("kind", ["v3", "v2", "v2-gz"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_from_checkpoint_matches_jax(jm, tm, tmp_path, kind, writer):
    """The mesh-direct restart from checkpoints written by either package:
    names and planes == niqki_tpu's from_checkpoint (its real rows), the
    planes == the device pack of the saved rows, counts == the saved
    niqki_tpu index's own."""
    p = JaxParams(lF=12, K=21, min_fract=0.05)
    jidx = _index_with_clusters(70, p, 9)
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    ck = tmp_path / "ck"
    _save(jidx if writer == "jax" else tidx, ck, kind)
    js = JShardedIndex.from_checkpoint(str(ck), jm)
    ts = ShardedIndex.from_checkpoint(str(ck), tm)
    assert ts.names == js.names == jidx.names and ts._Gp == js._Gp == 512
    q = _queries(jidx.matrix())
    np.testing.assert_array_equal(ts.counts(q), jidx.counts(q))
    planes = ts._planes.to_host()
    np.testing.assert_array_equal(planes[:, :70], np.asarray(
        js._planes).view(np.int32)[:, :70])
    np.testing.assert_array_equal(planes[:, :70], bcount.pack_bitplanes(
        torch.from_numpy(tidx._stored()), W=p.W, query=False).numpy())
    # padding rows are stored-invalid in every shard. (niqki_tpu's
    # callback leaves rows of the shards wholly past G unwritten.)
    assert (planes[:p.W, 70:] == 0).all() and (planes[p.W, 70:] == -1).all()


def test_load_sharded_mesh_direct_lazy_matrix(tmp_path, tm, monkeypatch):
    p = JaxParams(lF=12, K=21, min_fract=0.05)
    jidx = _index_with_clusters(30, p, 10)
    ck = str(tmp_path / "ck")
    jidx.save_sharded(ck, num_shards=2, planes=True)
    q = _queries(jidx.matrix())
    want = jidx.counts(q)                # niqki_tpu on one device
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    mesh = auto.active_mesh("cpu")
    idx = SketchIndex.load_sharded(ck, device="cpu", mesh=mesh)
    assert idx._mat is None and idx._mat_loader is not None
    np.testing.assert_array_equal(idx.counts(q), want)
    assert idx._mat is None                     # served from the shards
    np.testing.assert_array_equal(idx.matrix(), jidx.matrix())
    assert idx.G == 30 and idx.names == jidx.names
    import json
    with open(os.path.join(ck, "manifest.json")) as f:
        m = json.load(f)
    for fmt, p_lF, msg in (("niqki_tpu.sharded.v1", 12, "v2/v3"),
                           ("niqki_tpu.sharded.v3", 10, "shape gate")):
        m["format"], m["params"]["lF"] = fmt, p_lF
        with open(os.path.join(ck, "manifest.json"), "w") as f:
            json.dump(m, f)
        with pytest.raises(ValueError, match=msg) as te:
            ShardedIndex.from_checkpoint(ck, tm)
        with pytest.raises(ValueError) as je:
            JShardedIndex.from_checkpoint(ck)
        assert str(te.value) == str(je.value)


def test_init_distributed_multi_process_not_ported():
    """The name is kept from when more than one process raised; the
    multi-process mesh runs in tests/test_torch_multihost.py. One process
    is a no-op, and a backend other than nccl/gloo or a missing
    coordinator raises before any connection is tried."""
    import torch.distributed as dist
    from niqki_tpu_torch.parallel.serving import init_distributed
    init_distributed(None, 1, 0)                 # one process: a no-op
    init_distributed(None, None, None)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend 'mpi'"):
        init_distributed("127.0.0.1:1234", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(None, 2, 0, backend="gloo")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# entry points

def test_dryrun_multichip_cpu():
    from niqki_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(8, device="cpu")
    assert "NIQKI_TPU_MESH" not in os.environ


def test_entry_matches_graft_entry():
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(repo)
    from niqki_tpu_torch.entry import entry
    jfn, jargs = graft.entry()
    tfn, targs = entry(device="cpu")
    for a, b in zip(jargs, targs):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32)
                                      if np.asarray(a).dtype == np.uint32
                                      else np.asarray(a), b.numpy())
    np.testing.assert_array_equal(tfn(*targs).numpy(),
                                  np.asarray(jax.jit(jfn)(*jargs)))


# ---------------------------------------------------------------------------
# the CLI under --mesh 2x4

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _lines_fa(path):
    """40 records of 1-3 kb (numpy seed 3), every fifth a 1% mutant of
    record 0, so that -l finds hits beyond each record itself."""
    rng = np.random.default_rng(3)
    base = rng.choice(list(b"ACGT"), 2500).astype(np.uint8)
    with open(path, "wb") as f:
        for i in range(40):
            if i % 5 == 0:
                s = base.copy()
                mut = rng.random(len(s)) < 0.01
                s[mut] = rng.choice(list(b"ACGT"), int(mut.sum()))
            else:
                s = rng.choice(list(b"ACGT"), int(rng.integers(1000, 3000)))
            f.write(b">r%d\n%s\n" % (i, s.astype(np.uint8).tobytes()))


@pytest.mark.parametrize("case", ["matrix", "query", "lines"])
def test_cli_mesh_matches_jax_and_single_device(tmp_path, monkeypatch, case):
    """-M (fof_tiny.txt at S=16: the uint16 wrap), -I/-Q at S=12 and -i/-l
    at S=12 with a hit cap of 4 (per-shard top-k with re-fetched rows)
    under --mesh 2x4: the port's bytes == niqki_tpu --mesh 2x4 == the port
    without a mesh; the mesh route runs, and NIQKI_TPU_MESH is restored."""
    from niqki_tpu import cli as jcli
    from niqki_tpu_torch import cli
    from niqki_tpu_torch.parallel import serving
    monkeypatch.chdir(tmp_path)
    if case == "matrix":
        args = ["-M", f"{FIXDIR}/fof_tiny.txt", "-S", "16", "-K", "21"]
    elif case == "query":
        with open("q.txt", "w") as f:
            f.write("".join(f"{FIXDIR}/{n}\n" for n in
                            ("tiny2.fa", "multi.fa", "tiny1.fa")))
        args = ["-I", f"{FIXDIR}/fof_tiny.txt", "-Q", "q.txt", "-S", "12",
                "-K", "21", "-J", "0.05"]
    else:
        _lines_fa("lines.fa")
        monkeypatch.setenv("NIQKI_TPU_HITS_CAP", "4")
        monkeypatch.setenv("NIQKI_TPU_HOST_READS", "0")  # the device route
        args = ["-i", "lines.fa", "-l", "lines.fa", "-S", "12", "-K", "21",
                "-J", "0.05"]
    assert jcli.main(args + ["--mesh", "2x4", "-O", "j.gz"]) == 0
    calls = []
    for name in ("counts", "topk_counts"):
        orig = getattr(serving.ShardedIndex, name)
        monkeypatch.setattr(serving.ShardedIndex, name,
                            lambda self, *a, _o=orig, _n=name:
                            calls.append(_n) or _o(self, *a))
    assert cli.main(args + ["--mesh", "2x4", "--device", "cpu",
                            "-O", "t.gz"]) == 0
    assert "NIQKI_TPU_MESH" not in os.environ
    assert calls and ("topk_counts" in calls) == (case != "matrix")
    n_mesh = len(calls)
    assert cli.main(args + ["--device", "cpu", "-O", "s.gz"]) == 0
    assert len(calls) == n_mesh                       # no mesh without it
    assert _gz("t.gz") == _gz("j.gz") == _gz("s.gz")
    if case == "matrix":
        assert _gz("t.gz") == _gz(f"{FIXDIR}/matrix_s16_tiny.gz")
    if case == "lines":
        rows = _gz("t.gz").split(b"\n")
        assert max(r.count(b":") for r in rows) > 4      # past the cap
