"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch sees no CUDA device. On a machine
with one (and without JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Results must be identical (integer semantics, tolerance 0).
"""

import numpy as np
import pytest
import torch

from niqki_tpu_torch import kernels
from niqki_tpu_torch.ops import bcount, pcount, psort

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_psort(xd, x):
    """One launch, equal to torch.sort, input untouched."""
    before = kernels.LAUNCHES["psort"]
    got = psort.sort_i32_pow2_batch(xd)
    assert kernels.LAUNCHES["psort"] == before + 1
    assert torch.equal(got, psort.sort_plain(xd))
    assert torch.equal(xd.cpu(), torch.from_numpy(x))


@pytest.mark.parametrize("B,m", [
    (1, 10), (3, 12), (2, 13), (5, 15), (3, 16), (2, 17), (1, 18), (4, 14),
    (256, 17), (1, 23), (6, 23), (7, 10), (3, 11)])
def test_psort_kernel_matches_plain(card, B, m):
    """Random rows at every tile size (2^10 and 2^11 below one 4096-key
    tile) up to the main path's 256 x 2^17 and 6 x 2^23."""
    rng = np.random.default_rng(m)
    x = rng.integers(-2**31, 2**31, (B, 1 << m)).astype(np.int32)
    if m == 14:
        x %= 5                                   # heavy duplicates
    _check_psort(torch.from_numpy(x).to(card), x)


@pytest.mark.parametrize("kind", ["edges", "constant", "sketch_keys"])
@pytest.mark.parametrize("m", [10, 17])
def test_psort_kernel_special_rows(card, kind, m):
    """Rows of INT32_MIN / INT32_MAX / -1 / 0 (the sign flip), rows of one
    value (every key in one digit bucket each pass), and sketch-like keys
    below 2^27 with 45% INT32_MAX padding (the skewed top digit)."""
    rng = np.random.default_rng(len(kind) + m)
    N = 1 << m
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if kind == "edges":
        x = rng.choice(np.array([lo, hi, -1, 0, lo + 1, hi - 1, 1, -2],
                                np.int32), (4, N))
        x[0] = rng.integers(lo, hi, N, dtype=np.int32)   # edges sprinkled
        x[0, ::7], x[0, 1::7], x[0, 2::7], x[0, 3::7] = lo, hi, -1, 0
    elif kind == "constant":
        x = np.stack([np.full(N, v, np.int32) for v in (lo, -1, 0, hi, 12345)])
    else:
        x = rng.integers(0, 1 << 27, (3, N)).astype(np.int32)
        x[rng.random(x.shape) < 0.45] = hi
    _check_psort(torch.from_numpy(np.ascontiguousarray(x)).to(card), x)


def _bcount_planes(card, P, Qb, G, L):
    rng = np.random.default_rng(P * 1000 + Qb)
    W = P - 1
    g = rng.integers(-3, 6, (G, L * 32)).astype(np.int32)
    q = rng.integers(-3, 6, (Qb, L * 32)).astype(np.int32)
    xp = bcount.pack_bitplanes(torch.from_numpy(g).to(card), W=W,
                               query=False)
    qp = bcount.pack_bitplanes(torch.from_numpy(q).to(card), W=W,
                               query=True)
    return qp, xp


def _check_bcount(qp, xp):
    """One launch, equal to the plain version; returns the counts."""
    before = kernels.LAUNCHES["bcount"]
    got = bcount._bcount_call(qp, xp)
    assert kernels.LAUNCHES["bcount"] == before + 1
    assert torch.equal(got, bcount._bcount_plain(qp, xp))
    assert int(got.max()) > 0
    return got


@pytest.mark.parametrize("P,Qb,G,L", [
    (13, 96, 4096, 1024), (17, 96, 4096, 1024), (13, 7, 200, 128),
    (31, 100, 300, 8), (2, 33, 65, 16), (13, 768, 4096, 1024),
    (13, 96, 256, 1024), (13, 97, 4097, 1024), (31, 96, 4096, 1024),
    (16, 200, 1000, 64)])
def test_bcount_kernel_matches_plain(card, P, Qb, G, L):
    """Every route of bcount._plan: one tile row with the lanes split
    (96 x 256 into 128 ranges of 8 lanes; the -Q shape into 8), ragged
    query and row edges against the 96 x 128 tile (97 x 4097), the 2-lane
    chunk at P = 17 and 31 (P = 31 with L = 8: one chunk pair a block),
    the 4-lane chunk at its largest P = 16, and the -M shape unsplit."""
    _check_bcount(*_bcount_planes(card, P, Qb, G, L))


@pytest.mark.parametrize("lo,B", [(0, 768), (768, 768), (4000, 96)])
def test_bcount_self_join_shapes(card, lo, B):
    """The self-join's query planes, index rows re-encoded by
    _planes_as_queries: a MATRIX_BLOCK of the sweep and the 96-row overflow
    re-fetch at the index's ragged end (G = 4096 + 5 rows)."""
    _, xp = _bcount_planes(card, 13, 1, 4101, 1024)
    qp = bcount._planes_as_queries(xp, lo, B)
    got = _check_bcount(qp, xp)
    rows = torch.arange(qp.shape[1], device=card)
    assert torch.equal(got[rows, lo + rows], got.max(dim=1).values)


@pytest.mark.parametrize("P", [13, 17])
@pytest.mark.parametrize("lo,C", [(640, 2000), (3072, 1024), (384, 128),
                                  (4000, 96)])
def test_bcount_window_views(card, P, lo, C):
    """K2 over a row window xp[:, lo:lo+C] of resident planes, as the
    symmetric sweep launches it: from mid-planes, ending at Gp, a single
    128-row tile, a ragged end. The kernel reads the view in place (the
    planes' pitch apart): the call allocates its output and nothing else
    (the caching allocator may hand out up to 2 MiB more than asked; a
    copy of the window would add more than that), and the counts equal
    the plain version on the same view and the whole planes' counts in
    those columns."""
    slack = 2 << 20
    qp, xp = _bcount_planes(card, P, 96, 4096, 1024)
    win = xp[:, lo:lo + C]
    assert not win.is_contiguous() and bcount._plane_pitch(win) == 4096
    assert P * C * 1024 * 4 > slack
    torch.cuda.synchronize(card)
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    got = bcount._bcount_call(qp, win)
    torch.cuda.synchronize(card)
    assert torch.cuda.max_memory_allocated(card) - base < \
        got.numel() * 4 + slack
    assert torch.equal(got, bcount._bcount_plain(qp, win))
    assert torch.equal(got, bcount._bcount_call(qp, xp)[:, lo:lo + C])
    assert int(got.max()) > 0


def test_bcount_rejects_strided_rows(card):
    """A layout whose rows are not dense is refused, never copied."""
    qp, xp = _bcount_planes(card, 13, 96, 256, 16)
    with pytest.raises(ValueError, match="dense"):
        bcount._bcount_call(qp, xp[:, ::2])
    with pytest.raises(ValueError, match="dense"):
        bcount._bcount_call(qp[:, :, :8].contiguous(), xp[:, :, :8])


def test_sym_sweep_on_card_matches_full(card, tmp_path, monkeypatch):
    """The whole symmetric -M on the card (G = 2000, B = 128, QB = 2: 16
    blocks, windows of 16 down to 2 blocks past the index's end) writes the
    full sweep's bytes, at the default cap and at cap 64 (below the
    cluster size, so every row is re-counted dense); the symmetric sweep
    launches K2 over fewer columns."""
    import gzip
    from niqki_tpu_torch import SketchIndex, SketchParams, engine
    from niqki_tpu_torch.io.writers import GzTextWriter
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    G, n_clusters = 2000, 20
    rng = np.random.default_rng(8)
    anc = rng.integers(0, p.fingerprint_range, (n_clusters, p.F))
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    share = rng.random((G, p.F)) < 0.4
    mat[share] = anc[np.arange(G) % n_clusters][share]
    names = [f"g{i}" for i in range(G)]
    for k, v in (("NIQKI_TPU_MATRIX", "selfjoin"),
                 ("NIQKI_TPU_MATRIX_BLOCK", "128"),
                 ("NIQKI_TPU_MATRIX_QB", "2")):
        monkeypatch.setenv(k, v)
    for cap in ("1024", "64"):
        monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", cap)
        out, cols = {}, {}
        for sym in ("on", "off"):
            monkeypatch.setenv("NIQKI_TPU_MATRIX_SYM", sym)
            seen = []
            orig = bcount._bcount_call

            def spy(qp, xp):
                seen.append(int(xp.shape[1]))
                return orig(qp, xp)
            monkeypatch.setattr(bcount, "_bcount_call", spy)
            idx = SketchIndex.from_arrays(p, names, mat, device="cuda")
            path = tmp_path / f"{sym}{cap}.gz"
            with GzTextWriter(str(path)) as w:
                engine.query_matrix(idx, w)
            monkeypatch.setattr(bcount, "_bcount_call", orig)
            with gzip.open(path, "rb") as f:
                out[sym] = f.read()
            cols[sym] = sum(seen)
        assert out["on"] == out["off"] and b"g1\t" in out["on"]
        assert 0 < cols["on"] < cols["off"]


def test_bcount_split_launches_agree(card):
    """Two launches on one input give one output: the lane-split partial
    counts are added with integer atomics, exact in any order."""
    qp, xp = _bcount_planes(card, 13, 96, 4096, 1024)
    assert bcount._plan(13, 96, 4096, 1024)["split"] > 1
    a = bcount._bcount_call(qp, xp)
    b = bcount._bcount_call(qp, xp)
    assert torch.equal(a, b)
    assert torch.equal(a, bcount._bcount_plain(qp, xp))


def test_bcount_rejects_planes_out_of_range(card):
    qp = torch.zeros((32, 4, 16), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="2 <= P <= 31"):
        bcount._bcount_call(qp, qp)


def test_bcount_rejects_misaligned_lanes(card):
    qp = torch.zeros((13, 4, 12), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="L % 8"):
        bcount._bcount_call(qp, qp)


def _pcount_rows(Qb, G, F):
    """Random int16 fingerprints with clustered rows so counts reach F,
    stored -2 and query -3 sentinels and negative halves; query 0 equals
    row 0 and query Qb-1 shares half of row 1."""
    rng = np.random.default_rng(Qb * 7 + G + F)
    g = rng.integers(-2, 1 << 14, (G, F)).astype(np.int16)
    g[: min(G, 50)] = g[0]
    q = rng.integers(-3, 1 << 14, (Qb, F)).astype(np.int16)
    q[0] = g[0]
    q[-1, : F // 2] = g[1, : F // 2]
    q[q == -2] = -3
    return q, g


@pytest.mark.parametrize("Qb,G,F", [
    (64, 4096, 1024), (64, 102400, 1024), (64, 4096, 2048), (7, 200, 256),
    (100, 300, 512), (1, 65, 64), (130, 4096, 1024), (4096, 4096, 1024),
    (96, 4096, 1024), (129, 4097, 1024), (4, 300, 1 << 17)])
def test_pcount_kernel_matches_plain(card, Qb, G, F):
    """K3 at the main path's shapes (the whole -M call, 4096 x 4096 at
    S = 10, split into none; the -Q call, 96 x 4096, split 8 ways; 64
    queries against G = 4096 and 102,400 at S = 10, and S = 11), ragged
    edges against the 128 x 128 tile (129 x 4097, 130 x 4096, 7 x 200,
    1 x 65) and F = 2^17, whose 65,536 lanes the plan cuts into ranges
    within the 16-bit counters, with a query equal to a row."""
    q, g = _pcount_rows(Qb, G, F)
    xp = pcount.pack_rows(torch.from_numpy(g).to(card))
    qp = pcount.pack_rows(torch.from_numpy(q).to(card))
    before = kernels.LAUNCHES["pcount"]
    got = pcount._count_call(qp, xp)
    assert kernels.LAUNCHES["pcount"] == before + 1
    assert torch.equal(got, pcount._count_plain(qp, xp))
    assert int(got[0, 0]) == F and int(got.max()) == F


def test_pcount_split_launches_agree(card):
    """Two launches on one input give one output: the lane-split partial
    counts are added with integer atomics, exact in any order."""
    q, g = _pcount_rows(96, 4096, 1024)
    xp = pcount.pack_rows(torch.from_numpy(g).to(card))
    qp = pcount.pack_rows(torch.from_numpy(q).to(card))
    assert pcount._plan(96, 4096, 512)["split"] > 1
    a = pcount._count_call(qp, xp)
    b = pcount._count_call(qp, xp)
    assert torch.equal(a, b)
    assert torch.equal(a, pcount._count_plain(qp, xp))


def test_match_counts_packed_launches(card, monkeypatch):
    """A whole count call is one launch at G = 4096 with 4096 queries, and
    as many launches as _launch_ranges gives once the output budget is
    crossed; the counts are the same either way."""
    G = 4096
    q, g = _pcount_rows(G, G, 1024)
    gp = pcount.pack_rows(torch.from_numpy(g).to(card))
    want = pcount._count_plain(pcount.pack_rows(
        torch.from_numpy(q).to(card)), gp).cpu().numpy()
    kernels.reset_launches()
    np.testing.assert_array_equal(pcount.match_counts_packed(q, gp, G), want)
    assert kernels.LAUNCHES["pcount"] == 1
    monkeypatch.setattr(pcount, "OUT_BUDGET", 1000 * G)
    n = len(pcount._launch_ranges(G, G, pcount.OUT_BUDGET))
    assert n == 5
    np.testing.assert_array_equal(pcount.match_counts_packed(q, gp, G), want)
    assert kernels.LAUNCHES["pcount"] == 1 + n


def test_pcount_rejects_misaligned_lanes(card):
    qp = torch.zeros((4, 48), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="Fp % 32"):
        pcount._count_call(qp, qp)


def _write_records(path, lens, seed=3):
    """One FASTA record per length, cut from two random 110 kb ancestors
    at 1% point mutation."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    anc = [rng.choice(alpha, 110_000) for _ in range(2)]
    with open(path, "wb") as f:
        for i, n in enumerate(lens):
            a = anc[i % 2]
            st = rng.integers(0, len(a) - n + 1)
            s = a[st:st + n].copy()
            m = rng.random(n) < 0.01
            s[m] = rng.choice(alpha, int(m.sum()))
            f.write(b">r%d\n%s\n" % (i, s.tobytes()))
    return str(path)


# 2 records padded to 2^17 and 3 to 2^16 bases on the device (over
# HOST_SKETCH_MAX), 40 on the host sketcher
_LONG = (100_000, 65_000, 40_000, 52_000, 99_000)
_LENS = _LONG + tuple(range(150, 30_000, 740))


@pytest.mark.parametrize("mode", ["auto", "bcount"])
def test_lines_and_load_on_card_match_cpu(card, tmp_path, monkeypatch, mode):
    """insert_file_lines, query_file_lines and load on the card equal the
    port on the CPU; NIQKI_TPU_COUNT=bcount counts -l through K2."""
    from niqki_tpu_torch import SketchIndex, SketchParams, engine
    from niqki_tpu_torch.io.writers import GzTextWriter
    monkeypatch.setenv("NIQKI_TPU_COUNT", mode)
    path = _write_records(tmp_path / "r.fa", _LENS)
    p = SketchParams(lF=12, min_fract=0.05)
    out = {}
    kernels.reset_launches()
    for dev in ("cpu", "cuda"):
        idx = SketchIndex(p, device=dev)
        idx.insert_file_lines(path)
        idx.dump(str(tmp_path / f"{dev}.bin"))
        back = SketchIndex.load(str(tmp_path / f"{dev}.bin"), device=dev)
        assert back.device.type == dev and back.names == idx.names
        np.testing.assert_array_equal(back.matrix(), idx.matrix())
        for name, ix in (("idx", idx), ("back", back)):
            with GzTextWriter(str(tmp_path / f"{dev}{name}.gz")) as w:
                engine.query_file_lines(ix, path, w)
            with open(tmp_path / f"{dev}{name}.gz", "rb") as f:
                out[dev, name] = f.read()
        out[dev] = idx
    np.testing.assert_array_equal(out["cuda"].matrix(), out["cpu"].matrix())
    assert out["cuda"].names == out["cpu"].names
    import gzip
    want = gzip.decompress(out["cpu", "idx"])
    assert b">r0:1 " in want
    for key in (("cuda", "idx"), ("cuda", "back"), ("cpu", "back")):
        assert gzip.decompress(out[key]) == want
    assert kernels.LAUNCHES["psort"] > 0
    assert (kernels.LAUNCHES["bcount"] > 0) == (mode == "bcount")


def test_sketch_stream_launches_k1_for_long_records_only(card, tmp_path):
    """A chunk of short records launches no K1; a chunk with long records
    launches K1 once per padded length (2^16 and 2^17 here)."""
    from niqki_tpu_torch import SketchIndex, SketchParams
    idx = SketchIndex(SketchParams(lF=15), device="cuda")
    for lens, launches in ((_LENS[len(_LONG):], 0), (_LENS, 2)):
        path = _write_records(tmp_path / f"{launches}.fa", lens)
        kernels.reset_launches()
        n = sum(len(part) for part, _ in idx._sketch_stream(
            idx._iter_packed_with_headers(path)))
        assert n == len(lens)
        assert kernels.LAUNCHES["psort"] == launches


# ---------------------------------------------------------------------------
# checkpoints, the mxu route and --profile on the card

def _random_index(p, G, seed, device="cuda"):
    """An index of G random rows with clusters of 64 and 1% empty slots."""
    from niqki_tpu_torch import SketchIndex
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, p.fingerprint_range, (G, p.F)).astype(np.int32)
    share = rng.random((G, p.F)) < 0.5
    mat[share] = np.repeat(mat[::64], 64, axis=0)[:G][share]
    mat[rng.random((G, p.F)) < 0.01] = -1
    return SketchIndex.from_arrays(p, [f"r{i}" for i in range(G)], mat,
                                   device=device)


@pytest.mark.parametrize("lF,W,G", [(12, 12, 4100), (12, 16, 300),
                                    (15, 12, 1000)])
def test_native_pack_equals_card_planes(card, lF, W, G):
    """The host native pack of the matrix (checkpoint v3's planes) holds
    the bits of the index planes built on the card, rows [0, G)."""
    from niqki_tpu_torch import SketchParams
    idx = _random_index(SketchParams(lF=lF, W=W), G, seed=G)
    dev = idx._planes()[:, :G].cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(
        bcount.np_pack_bitplanes(idx.matrix(), W), dev)


@pytest.mark.parametrize("lF,route", [(12, "bcount"), (10, "pcount")])
def test_checkpoint_reload_counts_on_card(card, tmp_path, lF, route):
    """save_sharded (v3 raw, v2 gzip), then load_sharded on the card: the
    device copies start empty, and the counts through K2 (S=12) or K3
    (S=10, G >= 4096) equal the original's, one launch per count call."""
    from niqki_tpu_torch import SketchIndex, SketchParams
    p = SketchParams(lF=lF, min_fract=0.05)
    idx = _random_index(p, 4200, seed=lF)
    q = idx.matrix()[::50].copy()
    want = idx.counts(q)
    for tag, kw in (("v3", {"compress": False, "planes": True}),
                    ("v2", {"compress": True})):
        ck = str(tmp_path / tag)
        idx.save_sharded(ck, num_shards=3, **kw)
        back = SketchIndex.load_sharded(ck)
        assert back.device.type == "cuda" and back.names == idx.names
        assert (back._device_planes, back._device_packed) == (None, None)
        np.testing.assert_array_equal(back.matrix(), idx.matrix())
        kernels.reset_launches()
        np.testing.assert_array_equal(back.counts(q), want)
        assert kernels.LAUNCHES[route] == (1 if route == "pcount"
                                           else -(-len(q) // 96))
        assert kernels.LAUNCHES["pcount" if route == "bcount"
                                else "bcount"] == 0


def test_mxu_equals_k2_on_card(card, monkeypatch):
    """NIQKI_TPU_COUNT=mxu (bf16 one-hot products, float32 sums) equals K2
    at 96 queries x 4096 rows x F = 4096, and launches no kernel."""
    from niqki_tpu_torch import SketchParams
    p = SketchParams(lF=12)
    idx = _random_index(p, 4096, seed=96)
    rng = np.random.default_rng(97)
    q = idx.matrix()[rng.choice(4096, 96, replace=False)].copy()
    q[rng.random(q.shape) < 0.05] = -1
    monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
    want = idx.counts(q)
    assert int(want.max()) > 256        # past bf16's exact integers
    monkeypatch.setenv("NIQKI_TPU_COUNT", "mxu")
    kernels.reset_launches()
    np.testing.assert_array_equal(idx.counts(q), want)
    assert kernels.LAUNCHES == {"psort": 0, "bcount": 0, "pcount": 0}


def test_profiled_query_trace_names_k2(card, tmp_path, monkeypatch):
    """-I/-Q under --profile on the card: the output of the run without
    it, and a trace whose kernel events name K1 and K2."""
    import glob
    import gzip
    import json
    import os
    from niqki_tpu_torch import cli
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
    (tmp_path / "q.txt").write_text(f"{fix}/tiny2.fa\n{fix}/tiny1.fa\n")
    args = ["-I", f"{fix}/fof_tiny.txt", "-Q", "q.txt", "-S", "12", "-K",
            "21", "-J", "0.05"]
    assert cli.main(args + ["-O", "plain.gz"]) == 0
    assert cli.main(args + ["-O", "prof.gz", "--profile", "tr"]) == 0
    with gzip.open("plain.gz") as a, gzip.open("prof.gz") as b:
        assert a.read() == b.read()
    traces = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("bcount_kernel" in n for n in names), names
    assert any("radix_" in n for n in names), names


# ---------------------------------------------------------------------------
# the one-process mesh: shards on one card (NIQKI_TPU_VIRTUAL_DEVICES)

@pytest.fixture
def card_mesh(card, monkeypatch):
    """A 2x4 mesh of eight virtual devices, all the one card."""
    from niqki_tpu_torch.parallel.mesh import device_list, make_mesh
    monkeypatch.setenv("NIQKI_TPU_VIRTUAL_DEVICES", "8")
    return make_mesh(device_list("cuda"), dp=2, tp=4)


def _s15_planes(card, G=4096, seed=15):
    """(G, 2^15) stored fingerprints (W=12, clusters of 64 rows, 1% -2)
    and their planes on the card."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4096, (G, 1 << 15), dtype=np.int32)
    g[:64] = g[0]
    g[rng.random(g.shape) < 0.01] = -2
    gd = torch.from_numpy(g).to(card)
    return g, bcount.pack_bitplanes(gd, W=12, query=False)


@pytest.mark.parametrize("Q", [96, 768])
def test_mesh_k2_per_shard_equals_unsharded(card, card_mesh, Q):
    """K2 per shard at 2x4 (4 shards of 1024 rows, the dp slices of the
    padded queries) equals one unsharded K2 at Q x 4096 (S=15), with one
    launch per BLOCK_Q queries of each device; the self-join block (768
    rows re-encoded from the shards) equals bcount._self_join_dense."""
    from niqki_tpu_torch.parallel import sharded
    g, xp = _s15_planes(card)
    q = g[np.random.default_rng(1).choice(4096, Q, replace=False)]
    q = np.where(q < 0, -3, q)
    pad = -Q % (2 * bcount.BLOCK_Q)
    qpad = np.vstack([q, np.full((pad, q.shape[1]), -3, np.int32)])
    qp = bcount.pack_bitplanes(torch.from_numpy(qpad).to(card), W=12,
                               query=True)
    xs = sharded.shard_index(xp, card_mesh, axis=1)
    assert xs.parts[1][2] is xs.parts[0][2]          # replicas: one tensor
    kernels.reset_launches()
    got = sharded.sharded_count_planes(card_mesh)(qp, xs)
    assert kernels.LAUNCHES["bcount"] == 4 * (Q + pad) // bcount.BLOCK_Q
    assert torch.equal(got[:Q], bcount._bcount_call(qp[:, :Q].contiguous(),
                                                    xp))
    if Q == 768:
        kernels.reset_launches()
        dense = sharded.sharded_selfjoin(card_mesh, B=768, cap=None)(
            xs, 1000, 0)
        assert kernels.LAUNCHES["bcount"] == 4
        assert torch.equal(dense, bcount._self_join_dense(xp, 1000, B=768))


def test_mesh_k3_per_shard_equals_unsharded(card, card_mesh):
    """K3 per shard at 2x4 (S=10, 4096 queries, 4096 rows): one launch a
    device, equal to one unsharded K3 call."""
    from niqki_tpu_torch.parallel import sharded
    rng = np.random.default_rng(10)
    g = rng.integers(0, 4096, (4096, 1024)).astype(np.int16)
    g[:64] = g[0]
    g[rng.random(g.shape) < 0.01] = -2
    q = g.copy()
    q[rng.random(q.shape) < 0.05] = -3
    gp = pcount.pack_rows(torch.from_numpy(g).to(card))
    qp = pcount.pack_rows(torch.from_numpy(q).to(card))
    kernels.reset_launches()
    got = sharded.sharded_count_packed(card_mesh)(
        qp, sharded.shard_index(gp, card_mesh))
    assert kernels.LAUNCHES["pcount"] == 8
    assert torch.equal(got, pcount._count_call(qp, gp))


def test_mesh_sketch_dispatch_k1_per_device(card, card_mesh, monkeypatch):
    """Under --mesh 2x4 on the card each sketch batch is split over the 8
    devices, K1 once each; the sketches equal the single-device ones."""
    import os
    from niqki_tpu_torch import SketchIndex, SketchParams
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    paths = [f"{fix}/tiny{i}.fa" for i in (1, 2, 3)] + [f"{fix}/multi.fa"]
    p = SketchParams(lF=12, K=21)
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    kernels.reset_launches()
    on = SketchIndex(p).sketch_files(paths)
    k1 = kernels.LAUNCHES["psort"]
    assert k1 > 0 and k1 % 8 == 0
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    kernels.reset_launches()
    off = SketchIndex(p).sketch_files(paths)
    assert kernels.LAUNCHES["psort"] * 8 == k1
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["v3", "v2"])
def test_mesh_from_checkpoint_counts_on_card(card, card_mesh, tmp_path,
                                             kind):
    """ShardedIndex.from_checkpoint on the card: the counts of 64 rows
    equal the saved index's (K2 per shard)."""
    from niqki_tpu_torch import SketchParams
    from niqki_tpu_torch.parallel.serving import ShardedIndex
    p = SketchParams(lF=12, min_fract=0.05)
    idx = _random_index(p, 4200, seed=3)
    q = idx.matrix()[::66].copy()
    want = idx.counts(q)
    ck = str(tmp_path / "ck")
    idx.save_sharded(ck, num_shards=3, compress=kind == "v2",
                     planes=kind == "v3")
    srv = ShardedIndex.from_checkpoint(ck, card_mesh)
    assert srv._planes.parts[0][0].device.type == "cuda"
    kernels.reset_launches()
    np.testing.assert_array_equal(srv.counts(q), want)
    assert kernels.LAUNCHES["bcount"] == 8


def test_dryrun_multichip_on_card(card, card_mesh):
    """entry.dryrun_multichip(8) on eight virtual devices of the card."""
    from niqki_tpu_torch.entry import dryrun_multichip
    kernels.reset_launches()
    dryrun_multichip(8)
    assert kernels.LAUNCHES["bcount"] > 0 and kernels.LAUNCHES["psort"] > 0


def _ecoli_codes(n=4_640_000, seed=19):
    """(eff_fwd, eff_rc) of a random E. coli-sized record with runs of N
    (eff_rc zeroed there, as the encoders do)."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 4, n).astype(np.uint8)
    r = (3 - f).astype(np.uint8)
    for at in rng.integers(0, n - 500, 20):
        f[at:at + 500] = 0
        r[at:at + 500] = 0
    return f, r


def test_sketch_codes_on_card_matches_plain(card, monkeypatch):
    """sketch_codes of a 4.64 Mbp record on the card: one K1 launch at
    1 x 2^23, the table equal to the same call with torch.sort in K1's
    place (no K1 launch), to the CPU's plain route and to the host's
    rolling sketch; dispatch_sketch leaves the table on the card."""
    from niqki_tpu_torch import SketchParams, native
    from niqki_tpu_torch.ops import sketch
    p = SketchParams()
    f, r = _ecoli_codes()
    kernels.reset_launches()
    got = sketch.sketch_codes(f, r, p, device=card)
    assert kernels.LAUNCHES["psort"] == 1
    dev = sketch.dispatch_sketch(f, r, p, device=card)
    assert dev.device.type == "cuda"
    np.testing.assert_array_equal(dev.cpu().numpy(), got)
    monkeypatch.setattr(sketch, "sort_i32_pow2_batch", psort.sort_plain)
    kernels.reset_launches()
    np.testing.assert_array_equal(sketch.sketch_codes(f, r, p, card), got)
    assert kernels.LAUNCHES["psort"] == 0
    np.testing.assert_array_equal(sketch.sketch_codes(f, r, p, "cpu"), got)
    np.testing.assert_array_equal(
        native.sketch_codes_cpu(f, r, p.lF, p.K, p.W, p.H), got)


@pytest.mark.parametrize("W", [8, 12])
def test_short_last_block_on_card(card, monkeypatch, W):
    """match_counts_planes on the card over blocks of 96 with a short last
    one (96, 96, 17 queries): one K2 launch a block, each at its own B,
    counts == the plain blocked count."""
    from niqki_tpu_torch.ops import count
    rng = np.random.default_rng(W)
    F, G = 4096, 1000
    g = rng.integers(0, 1 << W, (G, F)).astype(np.int32)
    xp = bcount.build_index_planes(g, W, card)
    q = g[:209].copy()
    q[rng.random(q.shape) < 0.1] = -3
    q[50] = -3
    monkeypatch.setattr(bcount, "BLOCK_Q", 96)
    kernels.reset_launches()
    got = bcount.match_counts_planes(q, xp, G, W)
    assert kernels.LAUNCHES["bcount"] == 3
    want = count.match_counts(torch.from_numpy(q).to(card),
                              torch.from_numpy(g).to(card)).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[50] == 0).all()


def test_small_wrappers_on_card(card):
    """match_counts_bitplane == the plain blocked count, and sort_i32_pow2
    == torch.sort, on the card."""
    from niqki_tpu_torch.ops import count
    rng = np.random.default_rng(4)
    g = rng.integers(0, 4096, (300, 4096)).astype(np.int32)
    q = g[:50].copy()
    q[rng.random(q.shape) < 0.2] = 7
    kernels.reset_launches()
    got = bcount.match_counts_bitplane(q, g, 12, device=card)
    assert kernels.LAUNCHES["bcount"] == 1
    want = count.match_counts(torch.from_numpy(q).to(card),
                              torch.from_numpy(g).to(card)).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 17).astype(
        np.int32)).to(card)
    assert torch.equal(psort.sort_i32_pow2(x), torch.sort(x).values)
