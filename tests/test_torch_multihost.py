"""The port's multi-process mesh: two ranks over gloo on 127.0.0.1, each
with NIQKI_TPU_VIRTUAL_DEVICES=4 CPU devices, one global mesh of 8 under
2x4 and 1x8. The layouts run different collectives: 2x4 puts dp row 0
wholly on rank 0 and dp row 1 on rank 1; 1x8 splits the tp axis across
the ranks.

Each rank writes its results to a file; this process checks that the two
ranks' results are equal, and holds them against niqki_tpu on its own 8
XLA CPU devices (tests/conftest.py), or against niqki_tpu's counts on one
device and its per-shard contract over them where its Pallas interpret
mode would take minutes, and against niqki_tpu.oracle, on the same numpy
inputs from one seed. Tolerance 0: counts, gids and decompressed output
bytes are compared exactly. A spawn has a hard timeout of 120 s, and a
timeout or a non-zero exit fails the test: a hang is a fault of the port.
The ranks take two torch threads each, as they share the host with the
other test workers.
"""

import gzip
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import native, oracle as joracle
from niqki_tpu.ops.sketch import EXC_PAD, pack_codes
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu.parallel import mesh as jmesh
from niqki_tpu.parallel import sharded as jsh

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
LAYOUTS = ("2x4", "1x8")
SPAWN_TIMEOUT = 120
INT32_MAX = np.iinfo(np.int32).max
CAP = 4                    # forces both per-shard overflow rules
P12 = JaxParams(lF=12, K=21, min_fract=0.05)      # the bit-plane route

WORKER = r'''
import builtins, os, sys
rank, port, out, case = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
os.environ["NIQKI_TPU_VIRTUAL_DEVICES"] = "4"
import numpy as np
import torch
torch.set_num_threads(2)       # two ranks beside the other test workers
from niqki_tpu_torch import SketchIndex, SketchParams, cli
from niqki_tpu_torch.parallel import mesh as tmesh, sharded as tsh
from niqki_tpu_torch.parallel.serving import ShardedIndex, init_distributed

init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
inp = dict(np.load(os.path.join(out, "inputs.npz")))
res = {}


def mesh_of(lay):
    dp, tp = map(int, lay.split("x"))
    mesh = tmesh.make_mesh(tmesh.global_device_list("cpu"), dp=dp, tp=tp)
    assert mesh.multi_process and mesh.rank == rank
    return mesh


def functions(lay):
    mesh = mesh_of(lay)
    res[lay + "/count"] = tsh.sharded_count(mesh)(
        inp["q"], tsh.shard_index(inp["g"], mesh)).numpy()
    p = SketchParams(lF=5, K=21)
    index = tsh.shard_index(np.full((8, p.F), -2, np.int32), mesh)
    index, counts = tsh.make_ingest_step_packed(p, mesh)(
        inp["words"], inp["nv"], inp["epad"], index, 0)
    res[lay + "/ingest_index"] = index.to_host()
    res[lay + "/ingest_counts"] = counts.numpy()
    p12 = SketchParams(lF=12, K=21, min_fract=0.05)
    idx = SketchIndex.from_arrays(
        p12, [f"g{i}" for i in range(len(inp["mat"]))], inp["mat"],
        device="cpu")
    srv = ShardedIndex(idx, mesh)
    assert srv._kernel == "planes"
    res[lay + "/counts"] = srv.counts(inp["mq"])
    vals, gids, _ = srv.topk_counts(idx._query_side(inp["mq"]),
                                    int(inp["cap"]), p12.min_score)
    res[lay + "/topk"] = np.stack([vals, gids])
    B = min(768, srv._Gp)
    vals, gids, _ = srv.selfjoin_block(0, B, int(inp["cap"]), p12.min_score)
    res[lay + "/sj"] = np.stack([vals, gids])
    res[lay + "/sj_dense"] = srv.selfjoin_block(0, B, None, 0)


def engine(lay, tag, args):
    path = os.path.join(out, f"rank{rank}_{lay}_{tag}.gz")
    assert cli.main(args + ["-K", "21", "--device", "cpu", "--mesh", lay,
                            "-O", path]) == 0


def restart(tag):
    """from_checkpoint under 1x8, recording the files each rank opens."""
    mesh = mesh_of("1x8")
    opened = []
    real_open, real_os_open = builtins.open, os.open

    def tracked(fn):
        def run(path, *a, **k):
            opened.append(os.path.basename(os.fspath(path)))
            return fn(path, *a, **k)
        return run

    builtins.open, os.open = tracked(real_open), tracked(real_os_open)
    try:
        srv = ShardedIndex.from_checkpoint(os.path.join(out, tag), mesh)
    finally:
        builtins.open, os.open = real_open, real_os_open
    res[tag + "/opened"] = np.array(sorted(set(opened)))
    res[tag + "/counts"] = srv.counts(inp["cq"])


if case == "functions":
    for lay in ("2x4", "1x8"):
        functions(lay)
elif case == "matrix":
    engine("2x4", "m", ["-M", str(inp["fof"]), "-S", "16"])
else:
    engine("1x8", "q", ["-I", str(inp["fof"]), "-Q", str(inp["qfof"]),
                        "-S", "12"])
    for tag in ("v3", "v2"):
        restart(tag)
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
torch.distributed.destroy_process_group()
print(f"RANK_OK {rank}", flush=True)
'''


def _spawn(d: pathlib.Path, case: str) -> list:
    """Runs WORKER's ``case`` as ranks 0 and 1 and returns their results;
    a timeout (both ranks killed) or a non-zero exit fails the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = d / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ,
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    env.pop("NIQKI_TPU_MESH", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(d), case],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(d), env=env) for r in (0, 1)]
    deadline = time.time() + SPAWN_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"two ranks ({case}) did not finish within "
                    f"{SPAWN_TIMEOUT} s: a hang")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, \
            f"rank {r} ({case}) exited {p.returncode}:\n{out[-3000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in (0, 1)]


def _clustered(G: int, p, rng) -> np.ndarray:
    """Every 3rd row a near-copy of one base (a tie cluster of real hits),
    the rest random; the matrix of tests/test_torch_mesh_serving.py."""
    base = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    for i in range(0, G, 3):
        mat[i] = base
        mat[i, : i % 7] = (base[: i % 7] + 1) % p.fingerprint_range
    return mat


def _queries(mat) -> np.ndarray:
    q = mat[:5].copy()
    q[2, ::9] = -3
    q[3, ::7] = -1
    return q


def _jax_index(p, mat) -> JaxIndex:
    idx = JaxIndex(p)
    for i, row in enumerate(mat):
        idx.insert_sketch(row, f"g{i}")
    return idx


def _packed_inputs(rng, Q=4, L=900, T=8):
    """test_multihost.py's ingest input, chunked over T = 8 (tp = 8
    splits it too)."""
    p = JaxParams(lF=5, K=21)
    seqs = [bytes(rng.choice(list(b"ACGTN"), L, p=[.24] * 4 + [.04]))
            for _ in range(Q)]
    ws, nvs, es = [], [], []
    for s in seqs:
        ef, er = joracle.encode_record(s, p.K)
        words, nb, exc = pack_codes(ef, er, p.K)
        cw, nv, ce = jsh.chunk_packed(words, nb, exc, T, p.K)
        ws.append(cw)
        nvs.append(nv)
        es.append(ce)
    epad = np.full((Q, T, max(e.shape[1] for e in es)), EXC_PAD, np.int32)
    for i, e in enumerate(es):
        epad[i, :, :e.shape[1]] = e
    return p, seqs, np.stack(ws), np.stack(nvs).astype(np.int32), epad


# ---------------------------------------------------------------------------
# the sharded functions and ShardedIndex, both layouts in one spawn

@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_functions")
    rng = np.random.default_rng(0)            # one input for every rank
    g = rng.integers(0, 4096, (16, 64)).astype(np.int32)
    q = rng.integers(0, 4096, (4, 64)).astype(np.int32)
    q[1] = g[5]
    p5, seqs, words, nv, epad = _packed_inputs(rng)
    mat = _clustered(40, P12, rng)
    mq = _queries(mat)
    np.savez(d / "inputs.npz", g=g, q=q, words=words, nv=nv, epad=epad,
             mat=mat, mq=mq, cap=CAP)
    ranks = _spawn(d, "functions")
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    return dict(res=ranks[0], g=g, q=q, p5=p5, seqs=seqs, words=words,
                nv=nv, epad=epad, mat=mat, mq=mq,
                jcounts=_jax_index(P12, mat).counts(mq))


def _jax_mesh(lay):
    dp, tp = map(int, lay.split("x"))
    assert len(jax.devices()) == 8
    return jmesh.make_mesh(dp=dp, tp=tp)


def _put(jm, arr, spec):
    return jax.device_put(arr, NamedSharding(jm, spec))


@pytest.mark.parametrize("lay", LAYOUTS)
def test_sharded_count_two_ranks(functions, lay):
    """The twin of test_multihost.py's sharded_count worker."""
    f = functions
    got = f["res"][lay + "/count"]
    want = (f["q"][:, None, :] == f["g"][None, :, :]).sum(-1)
    jm = _jax_mesh(lay)
    jgot = np.asarray(jsh.sharded_count(jm)(_put(jm, f["q"], P("dp", None)),
                                            _put(jm, f["g"], P("tp", None))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)
    assert got[1, 5] == 64


@pytest.mark.parametrize("lay", LAYOUTS)
def test_ingest_step_packed_two_ranks(functions, lay):
    """The twin of test_multihost.py's make_ingest_step_packed worker: the
    chunks' min is an all-reduce MIN across the ranks, the dp slices an
    all-gather; index and counts == niqki_tpu's and the oracle's."""
    f = functions
    idx, counts = f["res"][lay + "/ingest_index"], \
        f["res"][lay + "/ingest_counts"]
    p = f["p5"]
    want = np.stack([np.where(s == -1, INT32_MAX, s) for s in (
        joracle.sketch_records([s], p) for s in f["seqs"])])
    Q = len(want)
    np.testing.assert_array_equal(idx[:Q], want)
    assert (idx[Q:] == -2).all()
    np.testing.assert_array_equal(
        counts, (want[:, None, :] == idx[None, :, :]).sum(-1))
    jm = _jax_mesh(lay)
    jidx, jcounts = jsh.make_ingest_step_packed(p, jm)(
        _put(jm, f["words"], P("dp", "tp", None)),
        _put(jm, f["nv"], P("dp", "tp")),
        _put(jm, f["epad"], P("dp", "tp", None)),
        _put(jm, np.full((8, p.F), -2, np.int32), P("tp", None)), 0)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(counts, np.asarray(jcounts))


def _shard_top(counts: np.ndarray, tp: int, Gs: int, k: int, min_score):
    """niqki_tpu's per-shard top-k contract from (Q, G) counts: per shard
    the k largest counts, descending, below min_score masked to 0."""
    G = counts.shape[1]
    full = np.zeros((len(counts), tp * Gs), np.int64)
    full[:, :G] = counts
    out = []
    for t in range(tp):
        v = -np.sort(-full[:, t * Gs:(t + 1) * Gs], axis=1)[:, :k]
        out.append(np.where(v >= min_score, v, 0))
    return np.concatenate(out, axis=1)


def _layout(lay, G):
    """(tp, rows a shard) of ShardedIndex's bit-plane layout at ``lay``."""
    from niqki_tpu_torch.ops import bcount as tbcount
    tp = int(lay.split("x")[1])
    return tp, -(-G // (tp * tbcount.TILE_G)) * tbcount.TILE_G


def _check_top(top, counts, tp, Gs, min_score):
    """vals == the contract; every kept gid lies in its shard and has the
    count beside it (gids compared as counts, where ties may reorder)."""
    vals, gids = top
    k = vals.shape[1] // tp
    np.testing.assert_array_equal(vals, _shard_top(counts, tp, Gs, k,
                                                   min_score))
    full = np.zeros((len(counts), tp * Gs), np.int64)
    full[:, :counts.shape[1]] = counts
    for r, c in zip(*np.nonzero(vals >= min_score)):
        t = c // k
        assert t * Gs <= gids[r, c] < (t + 1) * Gs
        assert full[r, gids[r, c]] == vals[r, c]


@pytest.mark.parametrize("lay", LAYOUTS)
def test_sharded_index_counts_and_topk_two_ranks(functions, lay):
    """ShardedIndex.counts == niqki_tpu's counts; topk_counts at cap 4
    (rows overflow their shards) == niqki_tpu's per-shard contract over
    those counts."""
    f = functions
    np.testing.assert_array_equal(f["res"][lay + "/counts"], f["jcounts"])
    top = f["res"][lay + "/topk"]
    assert (top[0][:, CAP - 1::CAP] >= P12.min_score).any()  # an overflow
    _check_top(top, f["jcounts"], *_layout(lay, len(f["mat"])),
               P12.min_score)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_selfjoin_block_two_ranks(functions, lay):
    """selfjoin_block of rows [0, B) (under 1x8 B = 768 query rows come
    from both ranks' shards; under 2x4 rank 1 counts nothing): the dense
    (B, Gp) block == niqki_tpu's counts of the real rows wrapped to
    uint16, 0 wherever a padding row is the query or the column; the
    capped block (rows overflow their shards) its per-shard contract."""
    f = functions
    mat = f["mat"]
    G = len(mat)
    tp, Gs = _layout(lay, G)
    B = min(768, tp * Gs)
    want = np.zeros((B, tp * Gs), np.int64)
    want[:G, :G] = _jax_index(P12, mat).counts(mat) & 0xFFFF
    np.testing.assert_array_equal(f["res"][lay + "/sj_dense"], want)
    top = f["res"][lay + "/sj"]
    assert (top[0, :G, CAP - 1::CAP] >= P12.min_score).any()  # overflow
    _check_top(top, want, tp, Gs, P12.min_score)


# ---------------------------------------------------------------------------
# the engine: -M in one spawn, -I/-Q and the mesh-direct restart in another

@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_matrix")
    np.savez(d / "inputs.npz", fof=str(FIX / "fof_tiny.txt"))
    _spawn(d, "matrix")
    return d


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    from niqki_tpu_torch import SketchIndex, SketchParams
    d = tmp_path_factory.mktemp("mh_engine")
    qfof = d / "queries.txt"    # two chunks of -Q's 96
    qfof.write_text("".join(f"{FIX}/tiny{1 + i % 3}.fa\n"
                            for i in range(100)))
    rng = np.random.default_rng(1)
    mat = _clustered(1024, P12, rng)
    cq = _queries(mat[::97])
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(len(mat))],
                                  mat, device="cpu")
    idx.save_sharded(str(d / "v3"), 4, compress=False, planes=True)
    idx.save_sharded(str(d / "v2"), 4, compress=True)
    np.savez(d / "inputs.npz", fof=str(FIX / "fof_tiny.txt"),
             qfof=str(qfof), cq=cq)
    ranks = _spawn(d, "serve")
    for k in ranks[0]:
        if not k.endswith("/opened"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                          err_msg=k)
    return dict(d=d, res=ranks, qfof=qfof, mat=mat, cq=cq)


def _gz(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def test_query_matrix_two_ranks_golden(matrix):
    """-M of fof_tiny at S=16 under 2x4 through the mesh sweep (rank 0
    counts, rank 1 takes part in every collective): each rank writes the
    whole output, and both equal matrix_s16_tiny.gz."""
    want = _gz(FIX / "matrix_s16_tiny.gz")
    for r in (0, 1):
        assert _gz(matrix / f"rank{r}_2x4_m.gz") == want


def test_query_fof_two_ranks(engine, tmp_path):
    """-I/-Q of 100 queries at S=12 under 1x8 (two chunks, sketched and
    counted in turn on the main thread across processes; rows past the cap
    re-counted dense) == niqki_tpu's output on one device."""
    from niqki_tpu import cli as jcli
    out = tmp_path / "j.gz"
    assert jcli.main(["-I", str(FIX / "fof_tiny.txt"), "-Q",
                      str(engine["qfof"]), "-S", "12", "-K", "21", "-O",
                      str(out)]) == 0
    want = _gz(out)
    assert want.count(b"\n") >= 100
    for r in (0, 1):
        assert _gz(engine["d"] / f"rank{r}_1x8_q.gz") == want


@pytest.mark.parametrize("tag", ["v3", "v2"])
def test_from_checkpoint_reads_own_shards(engine, tag):
    """ShardedIndex.from_checkpoint under 1x8 of 1024 rows in 4 shard
    files: rank 0 (tp columns 0-3, rows 0-511) opens only shards 0 and 1,
    rank 1 only shards 2 and 3; every rank reads the manifest and all
    names. Both count as niqki_tpu does."""
    data = {"v3": "planes_{:05d}.bin", "v2": "shard_{:05d}.bin.gz"}[tag]
    for r, res in enumerate(engine["res"]):
        opened = set(res[tag + "/opened"].tolist())
        files = {n for n in opened if not n.endswith((".names", ".json"))}
        assert files == {data.format(s) for s in (2 * r, 2 * r + 1)}, files
        assert {f"shard_{s:05d}.names" for s in range(4)} <= opened
        np.testing.assert_array_equal(
            res[tag + "/counts"],
            _jax_index(P12, engine["mat"]).counts(engine["cq"]))


# ---------------------------------------------------------------------------
# the mesh's ranks in one process

def test_mesh_ranks_one_process():
    """Without a process group every entry is rank 0's and the mesh calls
    no collective; a mesh over entries of other ranks raises, as does one
    that does not span the whole group."""
    import torch
    from niqki_tpu_torch.parallel import mesh as tmesh
    cpu = torch.device("cpu")
    devs = tmesh.global_device_list("cpu")
    assert devs == [tmesh.MeshDevice(0, cpu)]
    m = tmesh.make_mesh([cpu] * 8, dp=2, tp=4)
    assert not m.multi_process and m.rank == 0 and m.first_local == cpu
    assert m.owner(1, 3) == 0 and m.is_local(1, 3)
    assert m.row_home(1) == cpu and m.column_home(3) == cpu
    with pytest.raises(ValueError, match="span all"):
        tmesh.make_mesh([tmesh.MeshDevice(r, cpu) for r in (0, 1)],
                        dp=1, tp=2)
    with pytest.raises(ValueError, match="belongs to rank 0"):
        tmesh.make_mesh([tmesh.MeshDevice(1, cpu)] * 2, dp=1, tp=2)
