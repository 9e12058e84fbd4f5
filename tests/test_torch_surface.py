"""The rest of the JAX package's surface in the port, against niqki_tpu on
the same inputs, on the CPU: the per-record sketch of code arrays
(``ops.sketch.dispatch_sketch`` / ``sketch_codes`` / ``make_sketcher``)
and its sort route, the plain blocked count (``ops.count``) and the count
routes, ``SketchIndex.hits`` / ``all_vs_all_counts`` /
``insert_file_whole`` / ``_load_packed_with_headers``, the one-row sort,
the small helpers and NIQKI_TPU_NO_PREFAULT; and an AST diff that holds
the port's public names, class methods and ``NIQKI_TPU_*`` knobs to the
JAX package's. Sketch tables and counts are integers: tolerance 0.
"""

import ast
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import engine as jengine
from niqki_tpu import native as jnative
from niqki_tpu import oracle as joracle
from niqki_tpu import params as jparams
from niqki_tpu.ops import count as jcount
from niqki_tpu.ops import psort as jpsort
from niqki_tpu.ops import sketch as jsketch
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu_torch import SketchIndex, engine, hostmem, oracle, params
from niqki_tpu_torch.ops import count, psort, sketch
from niqki_tpu_torch.params import SketchParams

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FOF = os.path.join(FIXDIR, "fof_tiny.txt")
INT32_MAX = np.iinfo(np.int32).max


def _record(n, seed, K=31, n_runs=0):
    """Effective codes (eff_fwd, eff_rc) of a random record of n bases,
    with ``n_runs`` runs of N, encoded by the oracle."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for _ in range(n_runs):
        at = int(rng.integers(0, max(1, n - 50)))
        seq[at:at + 50] = ord("N")
    return oracle.encode_record(seq.tobytes(), K)


def _pair(kw, stale=None):
    """The same parameters in both packages (``stale``: -G's best H for
    that many bases, the stale mask_M / maximal_remainder)."""
    jp, tp = JaxParams(**kw), SketchParams(**kw)
    if stale is not None:
        jp, tp = jp.with_best_H(stale), tp.with_best_H(stale)
    return jp, tp


# ---------------------------------------------------------------------------
# the per-record sketch of code arrays

@pytest.mark.parametrize("case,kw,stale,n,runs", [
    ("S10", dict(lF=10), None, 50_000, 2),
    ("S15", dict(lF=15), None, 50_000, 0),
    ("lF24_scatter", dict(lF=24), None, 20_000, 1),
    ("W30_scatter", dict(lF=12, W=30), None, 20_000, 0),
    ("stale_G", dict(lF=12), 5e6, 30_000, 1),
    ("stale_G_carry", dict(lF=12), 1e9, 30_000, 0),
    ("K21_short", dict(lF=12, K=21), None, 40, 0),
])
def test_sketch_codes_matches_jax(case, kw, stale, n, runs):
    """sketch_codes == niqki_tpu.ops.sketch.sketch_codes, exactly:
    INT32_MAX where a slot is empty, no densify; K1's route (lF + Wb <=
    30), the scatter-min (lF = 24, W = 30), the -G stale constants and a
    record barely over K. dispatch_sketch and make_sketcher give the same
    table, and so does native.sketch_codes_cpu."""
    jp, tp = _pair(kw, stale)
    f, r = _record(n, len(case), tp.K, runs)
    want = np.asarray(jsketch.sketch_codes(f, r, jp))
    got = sketch.sketch_codes(f, r, tp, device="cpu")
    assert got.dtype == np.int32 and got.shape == (tp.F,)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()         # INT32_MAX where empty: no -1, no densify
    dev = sketch.dispatch_sketch(f, r, tp, device="cpu")
    assert dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), want)
    P = sketch.padded_size(n)
    pf, pr = np.zeros(P, np.uint8), np.zeros(P, np.uint8)
    pf[:n], pr[:n] = f, r
    fn = sketch.make_sketcher(tp, device="cpu")
    np.testing.assert_array_equal(
        fn(torch.from_numpy(pf), torch.from_numpy(pr), n - tp.K).numpy(),
        want)
    from niqki_tpu_torch import native
    np.testing.assert_array_equal(
        native.sketch_codes_cpu(f, r, tp.lF, tp.K, tp.W, tp.H, tp.mask_M,
                                tp.maximal_remainder), want)


def test_sketch_codes_of_a_record_without_kmers():
    """A record of length <= K has no table: dispatch_sketch gives None,
    sketch_codes an all-INT32_MAX table, as the JAX package's."""
    jp, tp = _pair(dict(lF=10))
    f, r = _record(31, 0)
    assert sketch.dispatch_sketch(f, r, tp, device="cpu") is None
    got = sketch.sketch_codes(f, r, tp, device="cpu")
    np.testing.assert_array_equal(got, jsketch.sketch_codes(f, r, jp))
    assert (got == INT32_MAX).all()


def test_sketch_codes_keeps_the_callers_eff_rc():
    """eff_rc is taken as given: an exception the caller zeroed is kept
    (never recomputed as 3 - code), as in the JAX package."""
    jp, tp = _pair(dict(lF=10))
    f, r = _record(20_000, 3)
    r = r.copy()
    r[1000:1400] = 0
    want = np.asarray(jsketch.sketch_codes(f, r, jp))
    np.testing.assert_array_equal(sketch.sketch_codes(f, r, tp, "cpu"), want)
    assert not np.array_equal(
        want, np.asarray(jsketch.sketch_codes(f, (3 - f).astype(np.uint8),
                                              jp)))


@pytest.mark.parametrize("route", ["packed_batch", "codes"])
def test_sort_route_takes_k1(monkeypatch, route):
    """Both entry points sort the composite keys through K1's wrapper,
    once a record, whatever the environment says; the table equals the one
    the same code gives with torch.sort in the wrapper's place."""
    tp = SketchParams(lF=10)
    f, r = _record(30_000, 9)
    calls = []
    orig = sketch.sort_i32_pow2_batch
    monkeypatch.setattr(sketch, "sort_i32_pow2_batch",
                        lambda x: calls.append(x.shape) or orig(x))
    monkeypatch.setenv("NIQKI_TPU_NO_PSORT", "1")      # a JAX knob only

    def run():
        if route == "codes":
            return sketch.sketch_codes(f, r, tp, device="cpu")
        rec = sketch.pack_codes(f, r, tp.K)
        [(_, dev)] = sketch.dispatch_sketch_packed_batch([rec], tp, "cpu")
        return dev.numpy()[0]

    got = run()
    assert len(calls) == 1 and calls[0][0] in (1, 2)
    monkeypatch.setattr(sketch, "sort_i32_pow2_batch",
                        lambda x: torch.sort(x, dim=1).values)
    np.testing.assert_array_equal(run(), got)


@pytest.mark.parametrize("m", [10, 12])
def test_sort_i32_pow2_matches_jax(m):
    """The one-row sort == niqki_tpu.ops.psort.sort_i32_pow2 (interpret
    mode) on keys with duplicates and both extremes."""
    rng = np.random.default_rng(m)
    x = rng.integers(-2**31, 2**31, 1 << m).astype(np.int32)
    x[:8] = [INT32_MAX, -2**31, 0, -1, 5, 5, 5, INT32_MAX]
    want = np.asarray(jpsort.sort_i32_pow2(jnp.asarray(x), interpret=True))
    got = psort.sort_i32_pow2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        psort.sort_i32_pow2(torch.zeros(1000, dtype=torch.int32))


# ---------------------------------------------------------------------------
# ops.count and the count routes

@pytest.mark.parametrize("Q,G,F,block", [(5, 7, 64, 128), (300, 9, 32, 128),
                                         (37, 11, 16, 8)])
def test_match_counts_matches_jax(Q, G, F, block):
    """match_counts and match_counts_blocked == niqki_tpu.ops.count's on
    the same sketches (sentinels included; blocks that divide Q and blocks
    that do not)."""
    rng = np.random.default_rng(Q)
    g = rng.integers(-2, 6, (G, F)).astype(np.int32)
    q = rng.integers(-3, 6, (Q, F)).astype(np.int32)
    q[0] = g[0]
    want = np.asarray(jcount.match_counts(jnp.asarray(q), jnp.asarray(g)))
    np.testing.assert_array_equal(
        np.asarray(jcount.match_counts_blocked(jnp.asarray(q),
                                               jnp.asarray(g),
                                               block_q=block)), want)
    qt, gt = torch.from_numpy(q), torch.from_numpy(g)
    np.testing.assert_array_equal(count.match_counts(qt, gt).numpy(), want)
    got = count.match_counts_blocked(qt, gt, block_q=block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == F


def _indexes(lF=12, K=21):
    jp = JaxParams(lF=lF, K=K, min_fract=0.01)
    tp = SketchParams(lF=lF, K=K, min_fract=0.01)
    jidx = JaxIndex(jp)
    jengine.insert_fof_whole(jidx, FOF)
    tidx = SketchIndex(tp, device="cpu")
    engine.insert_fof_whole(tidx, FOF)
    np.testing.assert_array_equal(tidx.matrix(), jidx.matrix())
    return jidx, tidx


@pytest.mark.parametrize("mode,route", [
    ("xla", "_counts_blocked"), ("bcount", "match_counts_planes"),
    ("auto", "_counts_blocked")])
def test_count_modes_route_as_named(monkeypatch, mode, route):
    """NIQKI_TPU_COUNT picks one route past the host count's threshold:
    ``xla`` the plain blocked count (ops.count), ``bcount`` K2's wrapper,
    ``auto`` the blocked count on an index under both kernels' G >= 4096
    gates, each once and no other; the counts equal the host count's and
    niqki_tpu's."""
    jidx, tidx = _indexes()
    want = tidx.counts(tidx.matrix())           # the native host count
    monkeypatch.setenv("NIQKI_TPU_COUNT", mode)
    monkeypatch.setenv("NIQKI_TPU_HOST_COUNT_G", "0")
    from niqki_tpu_torch.ops import bcount, pcount
    taken = []
    for owner, name in ((bcount, "match_counts_planes"),
                        (pcount, "match_counts_packed"),
                        (SketchIndex, "_counts_blocked")):
        orig = getattr(owner, name)
        monkeypatch.setattr(owner, name,
                            lambda *a, _n=name, _f=orig, **k:
                            taken.append(_n) or _f(*a, **k))
    got = tidx.counts(tidx.matrix())
    assert taken == [route]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jidx.counts(jidx.matrix()), want)


# ---------------------------------------------------------------------------
# SketchIndex: hits, all_vs_all_counts, insert_file_whole, packed headers

def test_index_queries_match_jax(monkeypatch):
    """all_vs_all_counts and hits of every genome == niqki_tpu's on
    fof_tiny's genomes, on the host count and on the blocked count."""
    jidx, tidx = _indexes()
    for host_g in ("2048", "0"):
        monkeypatch.setenv("NIQKI_TPU_HOST_COUNT_G", host_g)
        want = jidx.all_vs_all_counts()
        got = tidx.all_vs_all_counts()
        assert got.shape == (3, 3) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert (np.diag(got) == tidx.params.F).all()
        for row in tidx.matrix():
            assert tidx.hits(row) == jidx.hits(row)
        assert tidx.hits(tidx.matrix()[1])[0] == (tidx.params.F, 1)


def test_insert_file_whole_matches_jax():
    """insert_file_whole of each genome == niqki_tpu's (name defaults to
    the path; a given name is kept), and equals the fof ingest's row."""
    _, tidx = _indexes()
    jidx = JaxIndex(JaxParams(lF=12, K=21, min_fract=0.01))
    port = SketchIndex(SketchParams(lF=12, K=21, min_fract=0.01),
                       device="cpu")
    paths = [os.path.join(FIXDIR, f"tiny{i}.fa") for i in (1, 2, 3)]
    paths.append(os.path.join(FIXDIR, "multi.fa"))
    for i, path in enumerate(paths):
        name = None if i % 2 else f"g{i}"
        assert port.insert_file_whole(path, name) == \
            jidx.insert_file_whole(path, name) == i
    assert port.names == jidx.names
    assert port.names[1] == paths[1] and port.names[0] == "g0"
    np.testing.assert_array_equal(port.matrix(), jidx.matrix())
    np.testing.assert_array_equal(port.matrix()[:3], tidx.matrix())


@pytest.mark.parametrize("name", ["multi.fa", "tiny.fq", "tiny1.fa"])
def test_load_packed_with_headers_matches_jax(name):
    """_load_packed_with_headers == niqki_tpu's: (header, words, n_bases,
    exc_idx) per record, in order."""
    p = dict(lF=10, K=21)
    path = os.path.join(FIXDIR, name)
    want = JaxIndex(JaxParams(**p))._load_packed_with_headers(path)
    got = SketchIndex(SketchParams(**p),
                      device="cpu")._load_packed_with_headers(path)
    assert isinstance(got, list) and len(got) == len(want) > 0
    for (h, w, n, e), (jh, jw, jn, je) in zip(got, want):
        assert (h, n) == (jh, jn)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(e, je)


# ---------------------------------------------------------------------------
# small helpers and NIQKI_TPU_NO_PREFAULT

def test_small_helpers_match_jax():
    """params.INT32_EMPTY and oracle.sketch_record == niqki_tpu's."""
    assert params.INT32_EMPTY == jparams.INT32_EMPTY == -1
    rng = np.random.default_rng(4)
    s = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, 3000)]
    for lF in (8, 12):
        np.testing.assert_array_equal(
            oracle.sketch_record(s.tobytes(), SketchParams(lF=lF, K=21)),
            joracle.sketch_record(s.tobytes(), JaxParams(lF=lF, K=21)))


@pytest.mark.parametrize("knob", [None, "1"])
def test_no_prefault(monkeypatch, knob):
    """big_empty pre-faults a buffer of 128 MB and more on a thread pool;
    NIQKI_TPU_NO_PREFAULT=1 skips that. The buffer works either way."""
    if knob:
        monkeypatch.setenv("NIQKI_TPU_NO_PREFAULT", knob)
    pools = []
    real = hostmem.ThreadPoolExecutor
    monkeypatch.setattr(hostmem, "ThreadPoolExecutor",
                        lambda *a, **k: pools.append(1) or real(*a, **k))
    arr = hostmem.big_empty((128 << 20) // 4, np.int32)
    arr[::1 << 20] = 7
    assert int(arr[1 << 20]) == 7
    assert len(pools) == (0 if knob else 1)
    del arr


# ---------------------------------------------------------------------------
# the surface as a whole

# What of niqki_tpu's surface the port leaves out on purpose, each with its
# reason. Keys: "module.py" (the whole module), "module.py:name" (a
# top-level name) or "NIQKI_TPU_*" (a knob).
NOT_PORTED = {
    # The port never swaps a card kernel for its plain version: these two
    # knobs took K1 (NO_PSORT) or K2/K3 (NO_PCOUNT) off every path on the
    # card. The tests hold each kernel against its plain version directly,
    # and NIQKI_TPU_COUNT=xla forces the plain blocked count by name.
    "NIQKI_TPU_NO_PSORT": "would swap K1 for its plain sort on the card",
    "NIQKI_TPU_NO_PCOUNT": "would swap K2/K3 for the blocked count",
    # The split query wire (1.625 B a slot, the JAX package's default) was
    # set for a TPU transport's stream compressor; the card has none, and
    # int16 is the one wire until an H100 workload gains from another.
    "NIQKI_TPU_WIRE": "split query wire served a TPU transport",
    # TPU gates: the JAX package asks whether the backend is a TPU. The
    # port's kernels run wherever torch sees a card, and a CPU tensor takes
    # the plain version, so the port has no such question to ask.
    "ops/psort.py:available": "TPU backend gate",
    "ops/mxucount.py:available": "TPU backend gate",
    # torch has int64 tensors: the hashes run on 64-bit patterns
    # (tests/test_torch_sketch.py holds them against u32pair)
    "ops/u32pair.py": "uint32-pair arithmetic for a backend without int64",
    # JAX's persistent compile cache; the port's counterpart is the kernel
    # build directory (kernels.py)
    "NIQKI_TPU_NO_COMPILE_CACHE": "jax compile cache only",
    # the port has no such helper: parallel.auto.active_mesh is the gate
    "index.py:maybe_active_mesh": "parallel.auto.active_mesh gates instead",
    # K3's port takes pairs packed on the card: match_counts_pair and
    # pack_rows are their counterparts
    "ops/pcount.py:match_counts_pallas": "counterpart match_counts_pair",
    "ops/pcount.py:pack_rows_np": "counterpart pack_rows",
    # Pallas tiling constants of the TPU kernels; the Hopper kernels have
    # their own launch plans (psort._plan, bcount._plan)
    "ops/psort.py:CHUNK_LOG": "Pallas tiling constant",
    "ops/psort.py:LANES": "Pallas tiling constant",
    "ops/psort.py:LOG_LANES": "Pallas tiling constant",
    "ops/bcount.py:CHUNK_LANES": "Pallas tiling constant",
    # the sweep's wait / dispatch / emit times were stderr lines that
    # nothing read; the port's sweep.* spans (debug.tracing) carry them
    "NIQKI_TPU_MATRIX_STATS": "the sweep.* spans carry its numbers",
}
# NIQKI_TPU_COUNT=bcount-interpret (Pallas interpret mode) is a value, not
# a name: the port's COUNT_MODES leave it out, and the plain versions
# serve the tests.


def _env_names(tree):
    """NIQKI_TPU_* names the code looks up in, or sets into, ``os.environ``
    (``os.environ.get/pop/setdefault(name)``, ``os.getenv(name)``,
    ``os.environ[name]``, ``name in os.environ``, and a dict of such names
    merged into it); a name in a comment or a docstring is no knob."""
    def environ(n):
        return isinstance(n, ast.Attribute) and n.attr == "environ"

    def lit(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and n.value.startswith("NIQKI_TPU_"):
            return {n.value}
        if isinstance(n, ast.Dict):
            return set().union(*(lit(k) for k in n.keys if k is not None))
        return set()

    found = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and n.args:
            f = n.func
            if isinstance(f, ast.Attribute) and (
                    environ(f.value) or f.attr == "getenv"):
                found |= lit(n.args[0])
        elif isinstance(n, ast.Subscript) and environ(n.value):
            found |= lit(n.slice)
        elif isinstance(n, ast.Compare) and any(
                environ(c) for c in n.comparators):
            found |= lit(n.left)
    return found


def _surface(pkg, imports: bool):
    """(modules, {module: top-level names}, {(module, class): methods},
    knobs) of a package: names defined or assigned at the top of each
    module, and imported there where ``imports`` (a name the port's module
    takes from another, as bcount takes pad_rows from hostmem), private
    ones left out; the methods of each class with those of its bases in
    the same module; every NIQKI_TPU_* name its code reads from the
    environment."""
    root = os.path.join(REPO, pkg)
    mods, names, methods, knobs = set(), {}, {}, set()
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, root)
        mods.add(rel)
        with open(path) as f:
            src = f.read()
        tree = ast.parse(src)
        knobs |= _env_names(tree)
        top, classes = set(), {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                top.add(node.name)
            elif isinstance(node, ast.Assign):
                top |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
            elif isinstance(node, ast.ImportFrom) and imports:
                top |= {a.asname or a.name for a in node.names}
            if isinstance(node, ast.ClassDef):
                classes[node.name] = (
                    {b.id for b in node.bases if isinstance(b, ast.Name)},
                    {b.name for b in node.body
                     if isinstance(b, ast.FunctionDef)})
        names[rel] = {n for n in top if not n.startswith("_")}

        def all_methods(c):
            bases, own = classes[c]
            return own.union(*(all_methods(b) for b in bases
                               if b in classes))
        for c in classes:
            methods[(rel, c)] = all_methods(c)
    return mods, names, methods, knobs


def test_port_covers_the_jax_surface():
    """Every module, public top-level name, class method and NIQKI_TPU_*
    knob of niqki_tpu is in niqki_tpu_torch, but for NOT_PORTED; and every
    entry of NOT_PORTED is still in niqki_tpu and still absent from the
    port (the map holds no stale entry)."""
    jm, jn, jme, jk = _surface("niqki_tpu", imports=False)
    tm, tn, tme, tk = _surface("niqki_tpu_torch", imports=True)
    missing = {m for m in jm - tm}
    for rel, ns in jn.items():
        if rel in tm:
            missing |= {f"{rel}:{n}" for n in ns - tn[rel]}
    for (rel, c), ms in jme.items():
        if rel in tm:
            missing |= {f"{rel}:{c}.{m}"
                        for m in ms - tme.get((rel, c), set())}
    missing |= jk - tk
    assert missing == set(NOT_PORTED), (
        sorted(missing - set(NOT_PORTED)),
        sorted(set(NOT_PORTED) - missing))
    # the new surface of this slice, named
    for rel, n in (("ops/sketch.py", "dispatch_sketch"),
                   ("ops/sketch.py", "sketch_codes"),
                   ("ops/sketch.py", "make_sketcher"),
                   ("ops/count.py", "match_counts_blocked"),
                   ("ops/bcount.py", "match_counts_bitplane"),
                   ("ops/psort.py", "sort_i32_pow2"),
                   ("native.py", "gzip_member"),
                   ("native.py", "sketch_codes_cpu")):
        assert n in tn[rel], (rel, n)
    for k in ("NIQKI_TPU_GZLEVEL", "NIQKI_TPU_NO_NATIVE",
              "NIQKI_TPU_NO_NATIVE_BUILD", "NIQKI_TPU_NO_PREFAULT"):
        assert k in tk, k
