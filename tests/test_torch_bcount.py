"""The port's bit-plane count (niqki_tpu_torch.ops.bcount) against the JAX
package on the same inputs, on the CPU: the Pallas kernel runs in interpret
mode, the port's kernel wrapper takes its plain version for CPU tensors.
All comparisons are exact (integer semantics, tolerance 0).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import native
from niqki_tpu.ops import bcount as jb
from niqki_tpu.params import SketchParams
from niqki_tpu_torch import SketchIndex, kernels
from niqki_tpu_torch.ops import bcount, psort


def _i32(a):
    return np.array(a).view(np.int32)


def _mat_with_sentinels(rng, N, F, W):
    m = rng.integers(0, 1 << W, (N, F)).astype(np.int32)
    flat = m.reshape(-1)
    for v in (-1, -2, -3, (1 << W) - 1, 1 << W):
        flat[rng.choice(flat.size, 50, replace=False)] = v
    return m


def _dense_ref(q, g, W):
    qv = np.where((q < 0) | (q >= 1 << W), -3, q)
    gv = np.where((g < 0) | (g >= 1 << W), -2, g)
    return (qv[:, None, :] == gv[None, :, :]).sum(-1, dtype=np.int32)


@pytest.mark.parametrize("W", [12, 16])
@pytest.mark.parametrize("query", [False, True])
def test_pack_bitplanes_matches_jax(W, query):
    rng = np.random.default_rng(W + query)
    m = _mat_with_sentinels(rng, 6, 4096, W)
    want = _i32(jb.pack_bitplanes(jnp.asarray(m), W=W, query=query))
    got = bcount.pack_bitplanes(torch.from_numpy(m), W=W, query=query)
    assert got.dtype == torch.int32 and got.shape == (W + 1, 6, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P", [13, 17])
def test_bcount_plain_matches_pallas(P):
    W = P - 1
    rng = np.random.default_rng(P)
    g = _mat_with_sentinels(rng, 256, 4096, W)
    q = _mat_with_sentinels(rng, 8, 4096, W)
    q[0] = g[3]
    q[1, :2048] = g[100, :2048]
    qp = jb.pack_bitplanes(jnp.asarray(q), W=W, query=True)
    xp = jb.pack_bitplanes(jnp.asarray(g), W=W, query=False)
    want = np.asarray(jb._bcount_call(qp, xp, interpret=True))
    got = bcount._bcount_call(torch.from_numpy(_i32(qp)),
                              torch.from_numpy(_i32(xp))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _dense_ref(q, g, W))
    assert got[0, 3] > 3900 and got[1, 100] >= 1900


def test_sentinels_never_match():
    """Stored -2 and query -3 match nothing, not even each other."""
    W, F = 12, 4096
    g = np.zeros((128, F), np.int32)
    g[1] = -2
    q = np.zeros((2, F), np.int32)
    q[1] = -3
    xp = bcount.pack_bitplanes(torch.from_numpy(g), W=W, query=False)
    qp = bcount.pack_bitplanes(torch.from_numpy(q), W=W, query=True)
    got = bcount._bcount_call(qp, xp).numpy()
    assert got[0, 0] == F and got[0, 1] == 0
    assert got[1, 0] == 0 and got[1, 1] == 0


def _planes_pair(seed, G=256, F=4096, W=12):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << W, (G, F)).astype(np.int32)
    anc = g[0].copy()
    for i in range(1, 40):                      # one cluster of 40 rows
        m = rng.random(F) < 0.5
        g[i, m] = anc[m]
    g[rng.random((G, F)) < 0.01] = -2
    xj = jb.build_index_planes(g, W, sanitized=True)
    xt = bcount.build_index_planes(g, W, torch.device("cpu"), sanitized=True)
    np.testing.assert_array_equal(xt.numpy(), _i32(xj))
    return g, xj, xt


def _survivors(vals, idx, min_score):
    return [set((int(v), int(i)) for v, i in zip(vr, ir) if v >= min_score)
            for vr, ir in zip(vals, idx)]


@pytest.mark.parametrize("cap", [16, 64])
def test_self_join_topk_matches_jax(cap):
    """vals equal (count-descending); survivors equal per row as
    (count, gid) sets, since tie order is free while they fit in cap."""
    g, xj, xt = _planes_pair(1)
    min_score = 100
    vj, ij = jb._self_join_topk(xj, 8, min_score, B=48, cap=cap,
                                interpret=True)
    vt, it = bcount._self_join_topk(xt, 8, min_score, B=48, cap=cap)
    vj, vt = np.asarray(vj).astype(np.int32), vt.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert (np.diff(vt, axis=1) <= 0).all()
    fits = vt[:, -1] < min_score
    sj = _survivors(vj, np.asarray(ij), min_score)
    st = _survivors(vt, it.numpy(), min_score)
    assert [s for s, f in zip(st, fits) if f] == \
        [s for s, f in zip(sj, fits) if f]
    # rows 8..39 are in the 40-row cluster: over a cap of 16, within 64
    assert fits[32:].all()
    assert fits[:32].all() if cap == 64 else not fits[:32].any()


def test_self_join_dense_matches_jax():
    """The uint16 wrap included: at F = 65536 a self-count wraps to 0."""
    g, xj, xt = _planes_pair(2)
    want = np.asarray(jb._self_join_dense(xj, 32, B=32, interpret=True))
    got = bcount._self_join_dense(xt, 32, B=32).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    W, F = 4, 65536
    m = np.zeros((1, F), np.int32)
    xw = bcount.build_index_planes(m, W, torch.device("cpu"))
    assert bcount._self_join_dense(xw, 0, B=1)[0, 0] == 0


def test_match_counts_planes_topk_matches_jax(monkeypatch):
    monkeypatch.setenv("NIQKI_TPU_WIRE", "int16")
    monkeypatch.setattr(jb, "BLOCK_Q", 16)      # a smaller interpret kernel
    g, xj, xt = _planes_pair(3, G=200)
    rng = np.random.default_rng(4)
    q = g[rng.choice(200, 10, replace=False)].copy()
    q[rng.random(q.shape) < 0.3] = -1
    vj, ij = jb.match_counts_planes(q, xj, 200, 12, interpret=True,
                                    topk=24, min_score=50)
    vt, it = bcount.match_counts_planes(q, xt, 200, 12, topk=24,
                                        min_score=50)
    np.testing.assert_array_equal(vt, np.asarray(vj))
    fits = vt[:, -1] < 50
    assert _survivors(vt[fits], it[fits], 50) == \
        _survivors(np.asarray(vj)[fits], np.asarray(ij)[fits], 50)
    dense = bcount.match_counts_planes(q, xt, 200, 12)
    np.testing.assert_array_equal(dense, _dense_ref(q, g[:200], 12))


@pytest.mark.parametrize("mode", ["auto", "bcount", "xla"])
def test_from_jax_counts(monkeypatch, mode):
    """A port index made from a JAX index counts what the JAX index counts,
    on every count route."""
    p = SketchParams(lF=12, K=21)
    rng = np.random.default_rng(6)
    jidx = JaxIndex(p)
    for i in range(20):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        sk[rng.random(p.F) < 0.02] = -1
        jidx.insert_sketch(sk, f"g{i}")
    q = jidx.matrix()[[3, 7]].copy()
    q[0, :100] = 5000                               # out of range -> -3
    want = jidx.counts(q)
    monkeypatch.setenv("NIQKI_TPU_COUNT", mode)
    tidx = SketchIndex.from_jax(jidx, device="cpu")
    assert tidx.names == jidx.names
    np.testing.assert_array_equal(tidx.counts(q), want)


def test_cuda_path_without_cuda_raises():
    """A non-CPU tensor never falls back to the plain version, and no
    launch is counted."""
    kernels.reset_launches()
    meta = torch.empty((2, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        psort.sort_i32_pow2_batch(meta)
    mp = torch.empty((13, 96, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        bcount._bcount_call(mp, mp)
    assert kernels.LAUNCHES == {"psort": 0, "bcount": 0, "pcount": 0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sees no card"):
            SketchIndex(SketchParams(lF=12), device="cuda")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "exists",
                        lambda p, _e=os.path.exists: (
                            _e(p) and not p.endswith("/nvcc")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_pretty_hits_batch_topk_route(monkeypatch):
    """G >= 4096: -Q rows go through the K2 top-k route and print exactly
    what the native formatter prints from dense host counts, including
    rows whose survivors overflow the cap (dense re-fetch)."""
    p = SketchParams(lF=12, K=21, min_fract=0.02)
    rng = np.random.default_rng(8)
    G = 4100
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    mat[10:60] = mat[10]                         # 50 identical rows
    idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(G)], mat,
                                  device="cpu")
    q = mat[[10, 500, 2000]].copy()
    headers = ["qa", "qb", "qc"]
    want = native.HitsFormatter(idx.names, p.F, p.min_score).format(
        native.count_eq(q, idx._stored(), p.fingerprint_range), headers)
    monkeypatch.setenv("NIQKI_TPU_HITS_CAP", "32")
    assert idx.pretty_hits_batch(q, headers) == want
    monkeypatch.setenv("NIQKI_TPU_HITS_CAP", "2048")
    assert idx.pretty_hits_batch(q, headers) == want
