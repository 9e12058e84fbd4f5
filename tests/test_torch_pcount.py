"""The port's pair-packed count K3 (niqki_tpu_torch.ops.pcount) and the
S <= 11 count route, against the JAX package on the same inputs, on the
CPU: the Pallas kernel runs in interpret mode, the port's kernel wrapper
takes its plain version for CPU tensors, and the JAX index counts through
its XLA route. All comparisons are exact (integer counts and output bytes,
tolerance 0).
"""

import gzip
import os
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import cli as jcli
from niqki_tpu import engine as jengine
from niqki_tpu import native
from niqki_tpu.io.writers import GzTextWriter as JaxWriter
from niqki_tpu.ops import pcount as jp
from niqki_tpu.params import SketchParams
from niqki_tpu_torch import SketchIndex, cli, engine, kernels
from niqki_tpu_torch.hostmem import pad_rows
from niqki_tpu_torch.io.writers import GzTextWriter
from niqki_tpu_torch.ops import bcount, pcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _pair_inputs(seed, Qb, G, F):
    """int16 rows with the sentinels: stored -2 slots, query -3 slots, -2
    padding rows, an exact duplicate query row, and negative values in both
    halves of a pair lane (-2 in the low half, -3 in the high half)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << 12, (G, F)).astype(np.int16)
    g[:20] = g[0]                                   # a cluster of 20
    g[rng.random((G, F)) < 0.02] = -2
    g[-8:] = -2                                     # padding rows
    q = rng.integers(0, 1 << 12, (Qb, F)).astype(np.int16)
    q[rng.random((Qb, F)) < 0.05] = -3
    q[0] = g[0]                                     # counts F against g[0]
    q[1, : F // 2] = g[5, : F // 2]
    q[2, 0::2], q[2, 1::2] = -2, -3                 # both halves negative
    return q, g


@pytest.mark.parametrize("F", [256, 512])
def test_count_plain_matches_pallas(F):
    q, g = _pair_inputs(F, 6, 256, F)
    want = np.asarray(jp._count_call(jnp.asarray(jp.pack_rows_np(q)),
                                     jnp.asarray(jp.pack_rows_np(g)),
                                     interpret=True))
    qp = pcount.pack_rows(torch.from_numpy(q))
    xp = pcount.pack_rows(torch.from_numpy(g))
    np.testing.assert_array_equal(qp.numpy(), jp.pack_rows_np(q))
    kernels.reset_launches()
    got = pcount._count_call(qp, xp).numpy()
    np.testing.assert_array_equal(pcount._count_plain(qp, xp).numpy(), got)
    np.testing.assert_array_equal(got, want)
    ref = (q[:, None, :] == g[None, :, :]).sum(-1, dtype=np.int32)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == F and got[1, 5] >= F // 2
    assert got[2, -8:].tolist() == [F // 2] * 8     # q -2 halves meet -2 rows
    assert kernels.LAUNCHES["pcount"] == 0          # plain on the CPU


@pytest.mark.parametrize("Q,G", [(5, 200), (70, 129)])
def test_match_counts_unaligned(Q, G):
    """Ragged Q and G go through the -2 query padding and the TILE_G row
    padding and come back sliced to (Q, G)."""
    q, g = _pair_inputs(Q + G, Q, G, 256)
    want = np.asarray(jp.match_counts_pallas(q, g, block_q=8,
                                             interpret=True))
    got = pcount.match_counts_pair(q, g, block_q=8)
    assert got.shape == (Q, G)
    np.testing.assert_array_equal(got, want)
    gp = pcount.pack_rows(torch.from_numpy(pad_rows(g, pcount.TILE_G)))
    np.testing.assert_array_equal(pcount.match_counts_packed(q, gp, G), want)


def test_count_call_checks_operands():
    a = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes differ"):
        pcount._count_call(a, torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        pcount._count_call(a, a.to(torch.int64))
    meta = torch.empty((4, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        pcount._count_call(meta, meta)
    with pytest.raises(ValueError, match="int16"):
        pcount.pack_rows(a)


@pytest.mark.parametrize("lF", range(5, 17))
def test_available_matches_jax_formula(lF):
    F = 1 << lF
    Fp = F // 2
    want = F % 256 == 0 and Fp % min(jp.CHUNK_LANES, Fp) == 0
    assert pcount.available(F) == want
    assert (pcount.TILE_G, pcount.CHUNK_LANES, pcount.PC_BLOCK_Q) == \
        (jp.TILE_G, jp.CHUNK_LANES, jp.PC_BLOCK_Q)


_SHAPES = [   # (Qb, G, Fp): the smoke's and the card tests' K3 launches
    (64, 4096, 512), (64, 102400, 512), (64, 4096, 1024), (4096, 4096, 512),
    (96, 4096, 512), (288, 4096, 512), (7, 200, 128), (100, 300, 256),
    (1, 65, 32), (130, 4096, 512), (129, 4097, 512), (4, 300, 65536),
    (896, 4096, 512), (640, 102400, 512), (4096, 4096, 65536)]


@pytest.mark.parametrize("Qb,G,Fp", _SHAPES)
def test_pcount_plan_covers_the_output(Qb, G, Fp):
    """csrc/pcount.cu's launch plan for every shape the smoke and the card
    tests launch, and F = 2^17: the lane ranges cover [0, Fp) once, in
    whole 32-lane chunks, each within the 16-bit counters' LANE_CAP; the
    tiles of the grid, walked as the kernel numbers its blocks (query tile
    fastest), cover every (q, g) once; the two stage buffers let two
    blocks share an SM."""
    plan = pcount._plan(Qb, G, Fp)
    lanes, split = plan["lanes"], plan["split"]
    assert lanes % pcount.KERNEL_LANES == 0 and lanes <= pcount.LANE_CAP
    ranges = [(s * lanes, min(Fp, (s + 1) * lanes)) for s in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == Fp
    assert all(a < b and (b - a) % pcount.KERNEL_LANES == 0
               for a, b in ranges)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    tq, tg = plan["tile_q"], pcount.KERNEL_TILE_G
    assert tq in pcount.KERNEL_TILES_Q
    assert all(-(-Qb // t) * t >= -(-Qb // tq) * tq
               for t in pcount.KERNEL_TILES_Q)       # the least padding
    nq = -(-Qb // tq)
    cover = np.zeros((nq * tq, -(-G // tg) * tg), np.uint8)
    for b in range(plan["tiles"]):
        q0, g0 = (b % nq) * tq, (b // nq) * tg
        cover[q0:q0 + tq, g0:g0 + tg] += 1
    assert (cover[:Qb, :G] == 1).all() and (cover <= 1).all()
    assert plan["blocks"] == plan["tiles"] * split
    # two buffers of (tile_q queries + 128 rows) x 36 words; an SM holds
    # 228 KiB, of which the runtime keeps 1 KiB per block
    assert plan["smem"] == 2 * (tq + tg) * 36 * 4
    assert pcount.BLOCKS_PER_SM * (plan["smem"] + 1024) <= 228 * 1024
    slots = pcount.BLOCKS_PER_SM * 132
    if Fp <= pcount.LANE_CAP and plan["tiles"] / (
            -(-plan["tiles"] // slots) * slots) >= pcount.FILL:
        assert split == 1          # a grid that fills its waves stays whole


@pytest.mark.parametrize("Q,G,budget", [
    (4096, 4096, pcount.OUT_BUDGET), (96, 4096, pcount.OUT_BUDGET),
    (10000, 102400, pcount.OUT_BUDGET), (4096, 4096, 1000 * 4096),
    (5, 200, 2 * 200), (70, 129, 8 * 129 + 5),
    (3, 1 << 27, pcount.OUT_BUDGET), (0, 4096, pcount.OUT_BUDGET)])
def test_launch_ranges_cover_the_queries(Q, G, budget):
    """match_counts_packed's launches cover the queries once, in order; each
    output stays within the budget (a launch holds at least one query) and
    every launch but the last fills it; below the budget a call is one
    launch."""
    ranges = pcount._launch_ranges(Q, G, budget)
    bounds = [0] + [hi for _, hi in ranges]
    assert [lo for lo, _ in ranges] == bounds[:-1] and bounds[-1] == Q
    step = max(1, budget // G)
    for lo, hi in ranges:
        assert hi > lo and ((hi - lo) * G <= budget or hi - lo == 1)
    assert all(hi - lo == step for lo, hi in ranges[:-1])
    if Q * G <= budget and Q:
        assert ranges == [(0, Q)]


def _clustered_jax_index(p, G=4096, seed=3):
    """A JAX index of G synthetic sketches: clusters of 64 rows sharing 60%
    of their slots with an ancestor, empty slots in every 9th row."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, p.fingerprint_range, (G // 64, p.F))
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    share = rng.random((G, p.F)) < 0.6
    mat[share] = anc[np.arange(G) // 64][share]
    mat[::9, :5] = -1
    jidx = JaxIndex(p)
    for i, row in enumerate(mat):
        jidx.insert_sketch(row, f"g{i}")
    return jidx


class _RouteSpy:
    def __init__(self, monkeypatch):
        self.calls = []
        for owner, name in ((pcount, "match_counts_packed"),
                            (bcount, "match_counts_planes"),
                            (SketchIndex, "_counts_blocked")):
            orig = getattr(owner, name)

            def spy(*a, _orig=orig, _name=name, **k):
                self.calls.append(_name)
                return _orig(*a, **k)
            monkeypatch.setattr(owner, name, spy)


@pytest.fixture(scope="module")
def s8_index():
    return _clustered_jax_index(SketchParams(lF=8, K=21, W=12))


def _queries(jidx, n=96, seed=4):
    rng = np.random.default_rng(seed)
    q = jidx.matrix()[rng.choice(jidx.G, n, replace=False)].copy()
    q[rng.random(q.shape) < 0.1] = -1
    q[:3, :7] = 5000                                 # out of range -> -3
    return q


def test_counts_route_pcount(monkeypatch, s8_index):
    """G = 4096 at lF = 8 (F = 256: the bit-plane gate fails): the port's
    counts go through K3's match_counts_packed and equal niqki_tpu's."""
    q = _queries(s8_index)
    want = s8_index.counts(q)
    tidx = SketchIndex.from_jax(s8_index, device="cpu")
    spy = _RouteSpy(monkeypatch)
    np.testing.assert_array_equal(tidx.counts(q), want)
    assert spy.calls == ["match_counts_packed"]
    assert tuple(tidx._device_packed.shape) == (4096, 128)
    assert want.max() > 200 and (want >= 100).sum() > 96


@pytest.mark.parametrize("case", ["no_pcount", "W16"])
def test_counts_route_blocked(monkeypatch, case, s8_index):
    """NIQKI_TPU_COUNT=xla (the one knob that keeps K3 off), and W = 16
    (int16 no longer lossless), take the blocked count."""
    jidx = s8_index
    if case == "no_pcount":
        monkeypatch.setenv("NIQKI_TPU_COUNT", "xla")
    else:
        p = SketchParams(lF=8, K=21, W=16)
        rng = np.random.default_rng(5)
        jidx = JaxIndex(p)
        for i, row in enumerate(rng.integers(-1, 1 << 16, (4096, p.F))):
            jidx.insert_sketch(row.astype(np.int32), f"g{i}")
    q = _queries(jidx, n=10)
    want = jidx.counts(q)
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    spy = _RouteSpy(monkeypatch)
    np.testing.assert_array_equal(tidx.counts(q), want)
    assert spy.calls == ["_counts_blocked"]
    assert tidx._device_packed is None


@pytest.mark.parametrize("mode", ["bcount-interpret", "blocked"])
def test_counts_unknown_mode_raises(monkeypatch, mode, s8_index):
    """A count mode the port does not route raises instead of quietly
    taking the plain blocked count."""
    monkeypatch.setenv("NIQKI_TPU_COUNT", mode)
    tidx = SketchIndex.from_jax(s8_index, device="cpu")
    with pytest.raises(ValueError, match="not one of auto, host"):
        tidx.counts(_queries(s8_index, n=2))


def test_cli_rejects_shards(capsys):
    """--shards belongs to the unported sharded checkpoint: the port's
    parser does not know it."""
    assert cli.main(["-M", f"{FIXDIR}/fof_tiny.txt", "--shards", "4",
                     "--device", "cpu"]) == 1
    assert "Bad usage" in capsys.readouterr().out


def test_insert_resets_packed_cache(s8_index):
    tidx = SketchIndex.from_jax(s8_index, device="cpu")
    q = _queries(s8_index, n=4)
    tidx.counts(q)
    assert tidx._device_packed is not None
    tidx.insert_sketch(q[0], "extra")
    assert tidx._device_packed is None
    c = tidx.counts(q)
    assert c.shape == (4, 4097) and c[0, -1] == c[0].max()


def test_query_fof_whole_s8(tmp_path, monkeypatch, s8_index):
    """-Q against the G = 4096, lF = 8 index: the dense K3 route writes
    niqki_tpu's bytes (pretty and binary)."""
    monkeypatch.chdir(tmp_path)
    qfof = tmp_path / "q.txt"
    qfof.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                            ("tiny2.fa", "multi.fa", "tiny1.fa")))
    tidx = SketchIndex.from_jax(s8_index, device="cpu")
    spy = _RouteSpy(monkeypatch)
    for pretty in (False, True):
        with JaxWriter("j.gz") as out:
            jengine.query_fof_whole(s8_index, str(qfof), out, pretty=pretty)
        with GzTextWriter("t.gz") as out:
            engine.query_fof_whole(tidx, str(qfof), out, pretty=pretty)
        assert _gz("t.gz") == _gz("j.gz")
    assert spy.calls == ["match_counts_packed"] * 2
    assert _gz("t.gz").count(b"\n") == 3


def test_query_matrix_s8(tmp_path, monkeypatch, s8_index):
    """-M's dense loop at G = 4096, lF = 8 (4096^2 cells formatted in Python
    on each side) through K3: niqki_tpu's bytes."""
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "auto")
    with JaxWriter(str(tmp_path / "j.gz")) as out:
        jengine.query_matrix(s8_index, out)
    tidx = SketchIndex.from_jax(s8_index, device="cpu")
    spy = _RouteSpy(monkeypatch)
    t = time.time()
    with GzTextWriter(str(tmp_path / "t.gz")) as out:
        engine.query_matrix(tidx, out)
    print(f"port query_matrix at G=4096, F=256: {time.time() - t:.1f} s")
    assert spy.calls == ["match_counts_packed"]
    got = _gz(tmp_path / "t.gz")
    assert got == _gz(tmp_path / "j.gz")
    assert got.count(b"\n") == 4097


@pytest.mark.parametrize("fn", ["query_fof_matrix", "query_file_matrix"])
def test_query_matrix_rows_s8(tmp_path, monkeypatch, fn, s8_index):
    """The matrix-row queries (external files against the index, no CLI
    flag) write niqki_tpu's bytes, through K3 at G = 4096."""
    monkeypatch.chdir(tmp_path)
    if fn == "query_fof_matrix":
        arg = tmp_path / "q.txt"
        arg.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                               ("tiny2.fa", "multi.fa", "missing.fa")))
    else:
        arg = f"{FIXDIR}/tiny3.fa"
    tidx = SketchIndex.from_jax(s8_index, device="cpu")
    spy = _RouteSpy(monkeypatch)
    with JaxWriter("j.gz") as out:
        getattr(jengine, fn)(s8_index, str(arg), out)
    with GzTextWriter("t.gz") as out:
        getattr(engine, fn)(tidx, str(arg), out)
    assert _gz("t.gz") == _gz("j.gz")
    assert spy.calls == ["match_counts_packed"]


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
@pytest.mark.parametrize("mode", ["-M", "-Q"])
def test_cli_s10_matches_jax(tmp_path, monkeypatch, mode):
    """-M -S 10 and -I ... -Q ... -S 10 on fof_tiny.txt (G = 3: the host
    count route) through both CLIs: the same bytes."""
    monkeypatch.chdir(tmp_path)
    fof = f"{FIXDIR}/fof_tiny.txt"
    if mode == "-M":
        args = ["-M", fof, "-S", "10"]
    else:
        qfof = tmp_path / "q.txt"
        qfof.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                                ("tiny3.fa", "tiny1.fa")))
        args = ["-I", fof, "-Q", str(qfof), "-S", "10", "-J", "0.01"]
    assert jcli.main(args + ["-O", "j.gz"]) == 0
    assert cli.main(args + ["-O", "t.gz", "--device", "cpu"]) == 0
    assert _gz("t.gz") == _gz("j.gz")
    assert len(_gz("t.gz")) > 20
