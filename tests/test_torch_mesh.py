"""The port's one-process device mesh (niqki_tpu_torch.parallel, ops.densify,
entry) against niqki_tpu's on the same numpy-seeded inputs. The port runs
its eight mesh devices as NIQKI_TPU_VIRTUAL_DEVICES=8 entries on the CPU
(plain kernel versions); niqki_tpu runs on its eight virtual CPU devices
(tests/conftest.py), Pallas in interpret mode. Tolerance 0 throughout:
counts, tables and output bytes are compared exactly; per-shard top-k
gids are compared as sets where ties may order them differently.
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
# mesh rules

def test_default_mesh_shape_matches_jax():
    for n in range(1, 17):
        assert tmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n)


def test_make_mesh_matches_jax_and_raises(jm):
    devs = tmesh.device_list("cpu")
    assert devs == [CPU] * 8
    tm = tmesh.make_mesh(devs, dp=2, tp=4)
    assert tm.shape == dict(jm.shape) == {"dp": 2, "tp": 4}
    assert tmesh.make_mesh(devs).shape == dict(jmesh.make_mesh().shape)
    for dp, tp in ((3, 2), (2, 2)):
        with pytest.raises(ValueError) as je:
            jmesh.make_mesh(dp=dp, tp=tp)
        with pytest.raises(ValueError) as te:
            tmesh.make_mesh(devs, dp=dp, tp=tp)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec,shape", [
    ("2x4", {"dp": 2, "tp": 4}), ("4x2", {"dp": 4, "tp": 2}),
    ("1x8", {"dp": 1, "tp": 8}), ("off", None), ("1x1", None), ("1", None),
    ("auto", None), ("", None)])
def test_active_mesh_matches_jax(monkeypatch, spec, shape):
    """auto stays off on the CPU, virtual devices included, as JAX's auto
    on its CPU devices; DxT takes the first D*T devices."""
    monkeypatch.setenv("NIQKI_TPU_MESH", spec)
    jmsh, tmsh = jauto.active_mesh(), auto.active_mesh("cpu")
    if shape is None:
        assert jmsh is None and tmsh is None
        return
    assert tmsh.shape == dict(jmsh.shape) == shape
    assert tmsh is auto.active_mesh("cpu")      # cached: one object a spec
    assert tmsh.flat() == [CPU] * 8


@pytest.mark.parametrize("spec", ["2x", "banana", "2x4x1", "4x4"])
def test_active_mesh_raises_like_jax(monkeypatch, spec):
    monkeypatch.setenv("NIQKI_TPU_MESH", spec)
    with pytest.raises(ValueError) as je:
        jauto.active_mesh()
    with pytest.raises(ValueError) as te:
        auto.active_mesh("cpu")
    assert str(te.value) == str(je.value)


def test_mesh_beyond_real_devices_needs_virtual(monkeypatch):
    monkeypatch.delenv("NIQKI_TPU_VIRTUAL_DEVICES")
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    with pytest.raises(ValueError, match="!= 1 devices"):
        auto.active_mesh("cpu")
    assert tmesh.device_list("cpu") == [CPU]


# ---------------------------------------------------------------------------
# densify_device

def _tables(lF, seed):
    """Tables with 1, 2, 5, F/8, F/2 and F-1 filled slots, one all empty,
    one full and the poly-N case (the only fingerprint 0: every probe is
    pinned, and the reference never terminates)."""
    F = 1 << lF
    rng = np.random.default_rng(seed)
    out = []
    for k in (1, 2, 5, F // 8, F // 2, F - 1, 0, F):
        t = np.full(F, INT32_MAX, np.int32)
        t[rng.choice(F, k, replace=False)] = rng.integers(0, 4096, k)
        out.append(t)
    poly = np.full(F, INT32_MAX, np.int32)
    poly[rng.choice(F, 3, replace=False)] = 0
    out.append(poly)
    return np.stack(out)


@pytest.mark.parametrize("lF", [6, 9])
def test_densify_device_matches_jax_oracle_native(lF):
    tabs = _tables(lF, lF)
    got = densify_device(torch.from_numpy(tabs), lF=lF).numpy()
    p = JaxParams(lF=lF)
    for t, g in zip(tabs, got):
        jgot = np.asarray(jdensify(t, lF=lF))
        np.testing.assert_array_equal(g, jgot)
        one = densify_device(torch.from_numpy(t), lF=lF).numpy()
        np.testing.assert_array_equal(one, g)       # (F,) == a batch row
        if (t == INT32_MAX).all():
            assert (g == INT32_MAX).all()           # all-empty: as it is
            continue
        ref = np.where(t == INT32_MAX, -1, t).astype(np.int32)
        nat = ref.copy()
        joracle.densify(ref, p)
        native.densify(nat)
        np.testing.assert_array_equal(np.where(g == INT32_MAX, -1, g), ref)
        np.testing.assert_array_equal(nat, ref)
    poly = got[-1]
    assert 0 < (poly != INT32_MAX).sum() < len(poly)   # stuck, terminated


# ---------------------------------------------------------------------------
# sharded building blocks against niqki_tpu.parallel.sharded

def _seqs(Q, L, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.choice(list(b"ACGT"), L)) for _ in range(Q)]


def test_chunk_codes_and_packed_match_jax():
    p = JaxParams(lF=6, K=21)
    for s in _seqs(3, 1000, 1) + [b"ACGTN" * 40]:
        ef, er = joracle.encode_record(s, p.K)
        for T in (1, 3, 4):
            for a, b in zip(tsh.chunk_codes(ef, T, p.K),
                            jsh.chunk_codes(ef, T, p.K)):
                np.testing.assert_array_equal(a, b)
            from niqki_tpu.ops.sketch import pack_codes
            w, n, exc = pack_codes(ef, er, p.K)
            for a, b in zip(tsh.chunk_packed(w, n, exc, T, p.K),
                            jsh.chunk_packed(w, n, exc, T, p.K)):
                np.testing.assert_array_equal(a, b)


def _code_batch(p, Q, L, T, seed):
    seqs = _seqs(Q, L, seed)
    f, r, nv = [], [], []
    for s in seqs:
        ef, er = joracle.encode_record(s, p.K)
        cf, n = jsh.chunk_codes(ef, T, p.K)
        cr, _ = jsh.chunk_codes(er, T, p.K)
        f.append(cf)
        r.append(cr)
        nv.append(n)
    return seqs, np.stack(f), np.stack(r), np.stack(nv).astype(np.int32)


@pytest.mark.parametrize("lF", [6, 12])
def test_sharded_sketch_batch_matches_jax(jm, tm, lF):
    """lF=6 sorts (K1's plain version); lF=12 at W=20 scatters."""
    p = JaxParams(lF=lF, K=21, W=12 if lF == 6 else 20)
    seqs, fwd, rc, nv = _code_batch(p, 4, 3000, 4, lF)
    want = np.asarray(jsh.sharded_sketch_batch(p, jm)(fwd, rc, nv))
    got = tsh.sharded_sketch_batch(_tparams(p), tm)(fwd, rc, nv).numpy()
    np.testing.assert_array_equal(got, want)
    raw = tsh.sharded_sketch_batch(_tparams(p), tm, densify=False)(
        fwd, rc, nv).numpy()
    np.testing.assert_array_equal(raw, np.asarray(
        jsh.sharded_sketch_batch(p, jm, densify=False)(fwd, rc, nv)))
    np.testing.assert_array_equal(
        np.where(got == INT32_MAX, -1, got)[0],
        joracle.sketch_records([seqs[0]], p))


def test_sharded_count_matches_jax(jm, tm):
    rng = np.random.default_rng(1)
    q = rng.integers(0, 5, size=(4, 64)).astype(np.int32)
    g = rng.integers(0, 5, size=(8, 64)).astype(np.int32)
    want = np.asarray(jsh.sharded_count(jm)(q, jsh.shard_index(g, jm)))
    idx = tsh.shard_index(g, tm)
    assert idx.parts[0][1] is idx.parts[1][1]      # dp replicas: one tensor
    got = tsh.sharded_count(tm)(q, idx).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(idx.to_host(), g)


def _planes_inputs(seed, G=512, Q=192, lF=12, W=12):
    """A clustered (G, F) stored index (-2 sentinels) and Q queries (-3
    sentinels), 8 of them copies of row 0, with their planes."""
    rng = np.random.default_rng(seed)
    F = 1 << lF
    g = rng.integers(0, 1 << W, (G, F)).astype(np.int32)
    g[: G // 4] = g[0]
    g[G // 4: G // 4 + 16, : F // 2] = g[0, : F // 2]
    g[rng.random((G, F)) < 0.01] = -2
    q = g[rng.choice(G, Q, replace=False)].copy()
    q[:8] = g[0]
    q[(rng.random(q.shape) < 0.05) | (q == -2)] = -3   # sanitized queries
    xp = np.asarray(jbcount.pack_bitplanes(g, W=W, query=False))
    qp = np.asarray(jbcount.pack_bitplanes(q, W=W, query=True))
    return g, q, xp, qp


def test_sharded_count_planes_matches_jax(jm, tm):
    g, q, xp, qp = _planes_inputs(2)
    want = np.asarray(jsh.sharded_count_planes(jm, interpret=True)(qp, xp))
    txp = tsh.shard_index(xp.view(np.int32), tm, axis=1)
    got = tsh.sharded_count_planes(tm)(torch.from_numpy(
        qp.view(np.int32)), txp).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (q[:, None] == g[None]).sum(-1))


def _topk_equal(tv, tg, jv, jg, tp, k, min_score):
    """Per-shard top-k: counts exactly, gids as sets where no tie at the
    cap can order them differently (rows under their shard's cap)."""
    np.testing.assert_array_equal(tv, jv)
    for r in range(len(tv)):
        for s in range(tp):
            blk = slice(s * k, (s + 1) * k)
            if tv[r, blk][-1] < min_score:
                assert sorted(tg[r, blk]) == sorted(jg[r, blk])


@pytest.mark.parametrize("cap,wrap16", [(4, False), (200, True)])
def test_sharded_count_planes_topk_matches_jax(jm, tm, cap, wrap16):
    g, q, xp, qp = _planes_inputs(3)
    ms = 2048
    jv, jg = jsh.sharded_count_planes_topk(jm, cap=cap, wrap16=wrap16,
                                           interpret=True)(qp, xp, ms)
    tv, tg = tsh.sharded_count_planes_topk(tm, cap=cap, wrap16=wrap16)(
        torch.from_numpy(qp.view(np.int32)),
        tsh.shard_index(xp.view(np.int32), tm, axis=1), ms)
    k = min(cap, 128)
    assert tv.shape == (192, 4 * k)
    _topk_equal(tv.numpy(), tg.numpy(), np.asarray(jv), np.asarray(jg), 4, k,
                ms)


@pytest.mark.parametrize("lo,cap", [(0, 8), (100, None), (320, 1024)])
def test_sharded_selfjoin_matches_jax(jm, tm, lo, cap):
    """B = 192 rows from [lo, lo+B) across shard edges (128-row shards),
    dense or per-shard top-k."""
    g, _, xp, _ = _planes_inputs(4)
    B, ms = 192, 100
    jres = jsh.sharded_selfjoin(jm, B=B, cap=cap, interpret=True)(xp, lo, ms)
    tres = tsh.sharded_selfjoin(tm, B=B, cap=cap)(
        tsh.shard_index(xp.view(np.int32), tm, axis=1), lo, ms)
    if cap is None:
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        want = (np.where(g[lo:lo + B] < 0, -3, g[lo:lo + B])[:, None]
                == g[None]).sum(-1) & 0xFFFF
        np.testing.assert_array_equal(tres.numpy(), want)
        return
    k = min(cap, 128)
    _topk_equal(tres[0].numpy(), tres[1].numpy(), np.asarray(jres[0]),
                np.asarray(jres[1]), 4, k, ms)


def test_sharded_count_packed_matches_jax(jm, tm):
    rng = np.random.default_rng(5)
    G, Q, F = 512, 128, 1024
    g = rng.integers(0, 4096, (G, F)).astype(np.int16)
    g[:64] = g[0]
    g[rng.random((G, F)) < 0.01] = -2
    q = g[rng.choice(G, Q, replace=False)].copy()
    q[rng.random(q.shape) < 0.05] = -3
    gp, qp = jpcount.pack_rows_np(g), jpcount.pack_rows_np(q)
    want = np.asarray(jsh.sharded_count_packed(jm, interpret=True)(qp, gp))
    got = tsh.sharded_count_packed(tm)(
        pcount.pack_rows(torch.from_numpy(q)),
        tsh.shard_index(pcount.pack_rows(torch.from_numpy(g)), tm)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (q[:, None] == g[None]).sum(-1))


@pytest.mark.parametrize("g0", [0, 5, 14])
def test_ingest_step_matches_jax(jm, tm, g0):
    """g0 = 14 puts rows past G = 16: they are dropped, never wrapped."""
    p = JaxParams(lF=6, K=21)
    _, fwd, rc, nv = _code_batch(p, 4, 2000, 4, 6)
    G = 16
    base = np.random.default_rng(7).integers(0, 64, (G, p.F)).astype(
        np.int32)
    jidx, jc = jsh.make_ingest_step(p, jm)(fwd, rc, nv,
                                           jsh.shard_index(base, jm), g0)
    tidx, tc = tsh.make_ingest_step(_tparams(p), tm)(
        fwd, rc, nv, tsh.shard_index(base, tm), g0)
    np.testing.assert_array_equal(tidx.to_host(), np.asarray(jidx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert not np.array_equal(tidx.to_host(), base)


def test_ingest_step_packed_matches_jax(jm, tm):
    from niqki_tpu.ops.sketch import EXC_PAD, pack_codes
    p = JaxParams(lF=12, K=21)
    Q, T, G = 4, 4, 16
    ws, nvs, es = [], [], []
    for s in _seqs(Q, 900, 8) + []:
        ef, er = joracle.encode_record(s, p.K)
        cw, nv, ce = jsh.chunk_packed(*pack_codes(ef, er, p.K), T, p.K)
        ws.append(cw)
        nvs.append(nv)
        es.append(ce)
    E = max(e.shape[1] for e in es)
    epad = np.full((Q, T, E), EXC_PAD, np.int32)
    for i, e in enumerate(es):
        epad[i, :, :e.shape[1]] = e
    args = (np.stack(ws), np.stack(nvs).astype(np.int32), epad)
    base = np.full((G, p.F), -2, np.int32)
    jidx, jc = jsh.make_ingest_step_packed(p, jm)(
        *args, jsh.shard_index(base, jm), 3)
    tidx, tc = tsh.make_ingest_step_packed(_tparams(p), tm)(
        *args, tsh.shard_index(base, tm), 3)
    np.testing.assert_array_equal(tidx.to_host(), np.asarray(jidx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
