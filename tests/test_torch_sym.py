"""The port's symmetric triangular -M sweep against niqki_tpu's.

Each block of B rows is counted against its upper-triangle column window
only and the host mirrors the lower half. On the clustered 300-genome index
of ``tests/test_matrix_selfjoin.py`` (lF=12, K=21, -J 0.05) with B = 128
and QB = 2 the windows shrink (3, 2, 2 blocks) and two of them cross the
index's end into the never-matching padding rows. niqki_tpu runs its own
symmetric sweep on the CPU (Pallas in interpret mode, as its tests run it)
and the port runs its plain kernel versions on ``device="cpu"``. Output
bytes must be identical: tolerance 0.
"""

import gzip

import numpy as np
import pytest
import torch

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import engine as jengine
from niqki_tpu import native
from niqki_tpu.io.writers import GzTextWriter
from niqki_tpu.ops import bcount as jbcount
from niqki_tpu.params import SketchParams
from niqki_tpu_torch import SketchIndex, engine, kernels
from niqki_tpu_torch.ops import bcount

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

B, QB = 128, 2
ENV = {"NIQKI_TPU_MATRIX": "selfjoin", "NIQKI_TPU_MATRIX_BLOCK": str(B),
       "NIQKI_TPU_MATRIX_QB": str(QB)}
NO_LAUNCHES = {"psort": 0, "bcount": 0, "pcount": 0}   # plain on the CPU


def _clustered(p, G, cluster, seed=44, interleave=False):
    """tests/test_matrix_selfjoin.py's clustered rows: each row shares 40%
    of its slots with its cluster's ancestor, every 7th row has 13 empty
    slots. Clusters are runs of ``cluster`` rows, or with ``interleave``
    row i is in cluster i % (G / cluster), so every cluster spans every
    block."""
    rng = np.random.default_rng(seed)
    n = -(-G // cluster)
    anc = rng.integers(0, p.fingerprint_range, (n, p.F)).astype(np.int32)
    mat = np.empty((G, p.F), np.int32)
    for i in range(G):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        m = rng.random(p.F) < 0.4
        sk[m] = anc[i % n if interleave else i // cluster][m]
        if i % 7 == 0:
            sk[rng.choice(p.F, 13, replace=False)] = -1
        mat[i] = sk
    return mat


def _jax_index(p, mat):
    jidx = JaxIndex(p)
    for i, row in enumerate(mat):
        jidx.insert_sketch(row, f"g{i}")
    return jidx


def _matrix_bytes(eng, idx, path):
    with GzTextWriter(str(path)) as out:
        eng.query_matrix(idx, out)
    with gzip.open(path, "rb") as f:
        return f.read()


def _setenv(mp, **extra):
    for k, v in {**ENV, **extra}.items():
        mp.setenv(k, str(v))


def _spy_sym(monkeypatch):
    """Record the stats of every symmetric sweep the engine runs."""
    calls = []
    orig = engine._query_matrix_selfjoin_sym

    def spy(index, out):
        calls.append(orig(index, out))
        return calls[-1]
    monkeypatch.setattr(engine, "_query_matrix_selfjoin_sym", spy)
    return calls


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """niqki_tpu's symmetric sweep of the 300-genome index at cap 16, where
    every cluster row overflows its top-k (its mirrors rebuilt from dense
    rows), run once; its bytes equal niqki_tpu's dense loop, so they are
    the matrix at every cap."""
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    mat = _clustered(p, 300, 100)
    jidx = _jax_index(p, mat)
    d = tmp_path_factory.mktemp("jax_sym")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIQKI_TPU_MATRIX", "dense")
        dense = _matrix_bytes(jengine, jidx, d / "dense.gz")
        _setenv(mp, NIQKI_TPU_MATRIX_SYM="on", NIQKI_TPU_MATRIX_CAP=16)
        want = _matrix_bytes(jengine, jidx, d / "sym.gz")
    assert want == dense
    return p, mat, jidx, want


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("cap", [1024, 16])
def test_sym_matches_jax(tmp_path, monkeypatch, ref, cap, mode):
    """SYM=on and auto take the port's symmetric sweep; its bytes equal
    niqki_tpu's symmetric sweep. At cap 16 every cluster row overflows: it
    is re-counted dense and its mirrors come from the dense row."""
    p, mat, _, want = ref
    _setenv(monkeypatch, NIQKI_TPU_MATRIX_SYM=mode, NIQKI_TPU_MATRIX_CAP=cap)
    calls = _spy_sym(monkeypatch)
    kernels.reset_launches()
    idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(len(mat))],
                                  mat, device="cpu")
    assert _matrix_bytes(engine, idx, tmp_path / "t.gz") == want
    assert kernels.LAUNCHES == NO_LAUNCHES
    [st] = calls
    assert st["N"] == 3 and st["window_cols"] == (3 + 2 + 2) * B
    assert st["mirror_entries"] > 0 and st["peak_mirror_bytes"] > 0
    assert (st["refetch"] > 0) == (cap == 16)
    # the index keeps one copy: a view of the extended planes
    assert tuple(idx._device_planes.shape) == (13, 384, 128)
    assert idx._device_planes.stride(0) == (3 + QB - 1) * B * 128


@pytest.mark.parametrize("cap", [1024, 16])
def test_sym_off_keeps_full_sweep(tmp_path, monkeypatch, ref, cap):
    """SYM=off takes the full sweep, which writes the symmetric sweep's
    bytes."""
    p, mat, _, want = ref
    _setenv(monkeypatch, NIQKI_TPU_MATRIX_SYM="off", NIQKI_TPU_MATRIX_CAP=cap)
    calls = _spy_sym(monkeypatch)
    idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(len(mat))],
                                  mat, device="cpu")
    assert _matrix_bytes(engine, idx, tmp_path / "t.gz") == want
    assert calls == []


def test_min_score_zero_keeps_full_sweep(tmp_path, monkeypatch, ref):
    """min_score == 0 prints every cell: SYM=on still takes the full
    sweep, whose bytes equal niqki_tpu's dense loop; the symmetric sweep
    refuses such an index."""
    _, mat, _, _ = ref
    p0 = SketchParams(lF=12, K=21)
    assert p0.min_score == 0
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    want = _matrix_bytes(jengine, _jax_index(p0, mat), tmp_path / "j.gz")
    _setenv(monkeypatch, NIQKI_TPU_MATRIX_SYM="on")
    calls = _spy_sym(monkeypatch)
    idx = SketchIndex.from_arrays(p0, [f"g{i}" for i in range(len(mat))],
                                  mat, device="cpu")
    assert _matrix_bytes(engine, idx, tmp_path / "t.gz") == want
    assert calls == []
    with pytest.raises(ValueError, match="min_score"):
        engine._query_matrix_selfjoin_sym(idx, None)


def test_sym_mode_unknown_raises(tmp_path, monkeypatch, ref):
    p, mat, _, _ = ref
    _setenv(monkeypatch, NIQKI_TPU_MATRIX_SYM="yes")
    idx = SketchIndex.from_arrays(p, [f"g{i}" for i in range(len(mat))],
                                  mat, device="cpu")
    with pytest.raises(ValueError, match="NIQKI_TPU_MATRIX_SYM"):
        _matrix_bytes(engine, idx, tmp_path / "t.gz")


def _survivors_agree(jv, jg, tv, tg, min_score):
    """Per row: the same kept values, and the same (gid, value) pairs
    above the least kept value of a full row (ties there may keep other
    gids) or at least min_score otherwise."""
    assert jv.shape == tv.shape
    for r in range(len(jv)):
        np.testing.assert_array_equal(np.sort(jv[r]), np.sort(tv[r]))
        floor = jv[r, -1] + 1 if jv[r, -1] >= min_score else min_score
        js, ts = jv[r] >= floor, tv[r] >= floor
        assert set(zip(jg[r][js], jv[r][js])) == set(zip(tg[r][ts],
                                                         tv[r][ts]))


def _windows(p, stored, lo, w, cap):
    """The port's window step on its extended planes, as numpy."""
    extra = (3 + QB - 1) * B - 384
    xt = bcount.extend_planes(bcount.build_index_planes(
        stored, p.W, "cpu", sanitized=True), extra)
    tv, tg = bcount._self_join_window_topk(xt, lo, p.min_score, B=B, w=w,
                                           cap=cap)
    tv, tg = tv.numpy(), tg.numpy()
    assert tv.shape == (B, min(cap, w * B))
    assert (tg[tv > 0] >= lo).all() and (tg[tv > 0] < 300).all()
    return xt, tv, tg


@pytest.mark.parametrize("lo,w", [(0, 3), (128, 2), (256, 2)])
def test_window_topk_matches_jax(ref, lo, w):
    """One window step (re-encode the block as query planes, count it
    against columns [lo, lo + w*B) of the extended planes, uint16 wrap,
    top min(cap, w*B), global gids, sub-min_score entries masked) at cap
    16 against niqki_tpu's ``_self_join_window_topk`` in interpret mode;
    the windows at lo = 128 and 256 run past the 384 index rows into
    padding."""
    p, _, jidx, _ = ref
    stored = jidx._stored()
    xt, tv, tg = _windows(p, stored, lo, w, 16)
    xj = jbcount.extend_planes(
        jbcount.build_index_planes(stored, p.W, sanitized=True),
        xt.shape[1] - 384)
    np.testing.assert_array_equal(np.asarray(xj).view(np.int32), xt.numpy())
    jv, jg = jbcount._self_join_window_topk(xj, lo, p.min_score, B=B, w=w,
                                            cap=16, interpret=True)
    _survivors_agree(np.asarray(jv).astype(np.int32), np.asarray(jg), tv,
                     tg, p.min_score)


@pytest.mark.parametrize("lo,w", [(0, 3), (128, 2), (256, 2)])
def test_window_topk_keeps_every_survivor(ref, lo, w):
    """At cap 1024 the window step keeps its whole window (k = w*B): its
    survivors are exactly the cells of the window that reach min_score in
    the dense counts (niqki_tpu's native count), count-descending."""
    p, _, jidx, _ = ref
    stored = jidx._stored()
    _, tv, tg = _windows(p, stored, lo, w, 1024)
    dense = native.count_eq(stored[lo:lo + B], stored,
                            p.fingerprint_range) & 0xFFFF
    assert (np.diff(tv, axis=1) <= 0).all()
    for r in range(min(B, 300 - lo)):
        cols = np.nonzero(dense[r, lo:] >= p.min_score)[0] + lo
        keep = tv[r] > 0
        assert set(zip(tg[r][keep], tv[r][keep])) == set(
            zip(cols, dense[r, cols]))


def test_extend_planes_rows_never_match():
    """Padding rows count 0 against every query, the padding rows
    re-encoded as queries included; the index rows are unchanged and
    extra = 0 returns the planes themselves."""
    p = SketchParams(lF=12, K=21)
    rng = np.random.default_rng(3)
    mat = rng.integers(0, p.fingerprint_range, (130, p.F)).astype(np.int32)
    xp = bcount.build_index_planes(mat, p.W, "cpu")
    assert bcount.extend_planes(xp, 0) is xp
    xpe = bcount.extend_planes(xp, 126)
    assert tuple(xpe.shape) == (13, 256 + 126, 128)
    assert torch.equal(xpe[:, :256], xp)
    q = bcount._planes_as_queries(xpe, 100, 282)   # index rows, then padding
    c = bcount._bcount_call(q, xpe)
    assert int(c[:, 130:].max()) == 0 and int(c[30:].max()) == 0
    rows = torch.arange(30)
    assert (c[rows, 100 + rows] == p.F).all()


def test_plane_pitch_of_windows():
    """Whole planes have pitch G; a row window keeps its parent's pitch;
    other layouts have none (the kernel would refuse them)."""
    xp = torch.zeros((13, 512, 16), dtype=torch.int32)
    assert bcount._plane_pitch(xp) == 512
    assert bcount._plane_pitch(xp[:, 100:228]) == 512
    assert bcount._plane_pitch(xp[:, :, :8]) is None
    assert bcount._plane_pitch(xp.transpose(1, 2)) is None


def test_mirror_bytes_bounded_when_every_row_overflows(tmp_path,
                                                       monkeypatch):
    """G = 512 in 4 clusters of 128 interleaved over the rows, cap 16:
    every row overflows its top-k, so every row is re-counted dense and
    mirrors its survivors beyond its block. The bytes equal niqki_tpu's;
    the mirror entries are exactly the survivor cells at or beyond column
    lo + B (from dense counts), and the peak bytes held stay within 10 B
    an entry of them."""
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    G = 512
    mat = _clustered(p, G, 128, seed=45, interleave=True)
    jidx = _jax_index(p, mat)
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    want = _matrix_bytes(jengine, jidx, tmp_path / "j.gz")
    _setenv(monkeypatch, NIQKI_TPU_MATRIX_SYM="on", NIQKI_TPU_MATRIX_CAP=16)
    calls = _spy_sym(monkeypatch)
    idx = SketchIndex.from_arrays(p, jidx.names, mat, device="cpu")
    assert _matrix_bytes(engine, idx, tmp_path / "t.gz") == want
    [st] = calls
    counts = native.count_eq(jidx._stored(), jidx._stored(),
                             p.fingerprint_range) & 0xFFFF
    surv = counts >= p.min_score
    rows = np.arange(G)[:, None]
    window = np.arange(G)[None, :] >= (rows // B) * B
    assert (np.sum(surv & window, axis=1) > 16).all()   # every row over cap
    assert st["refetch"] == (G // B) * 2                # two 96-row blocks
    beyond = int((surv & (np.arange(G)[None, :] >= (rows // B + 1) * B))
                 .sum())
    assert st["mirror_entries"] == beyond
    assert 0 < st["peak_mirror_bytes"] <= 10 * beyond
