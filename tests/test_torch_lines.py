"""The port's lines mode (-i / -l): each record of one FASTA/FASTQ file is
an index entry or a query. Held byte for byte against the reference
binary's goldens and against niqki_tpu on the same inputs (JAX on the
CPU); the port runs its plain kernel versions on the CPU. Tolerance 0:
decompressed output bytes and int32 matrices must be identical.
"""

import gzip
import os

import numpy as np
import pytest

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import cli as jcli
from niqki_tpu import native
from niqki_tpu.index import hits_from_counts_batch as jax_hits_batch
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu_torch import SketchIndex, SketchParams, cli
from niqki_tpu_torch import index as tindex
from niqki_tpu_torch.ops import bcount

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
# records over HOST_SKETCH_MAX bases take the device route (K1's plain
# version on the CPU); the rest the host sketcher
LONG = (33_000, 40_000, 36_500, 34_000)


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def write_records(path, n=100, seed=11):
    """n records cut from 4 random 45 kb ancestors at 1% point mutation,
    of log-uniform lengths from 100 bp to 40 kb; the first four are LONG."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    anc = [rng.choice(alpha, 45_000) for _ in range(4)]
    lens = np.exp(rng.uniform(np.log(100), np.log(40_000), n)).astype(int)
    lens[:len(LONG)] = LONG
    with open(path, "wb") as f:
        for i, n_bases in enumerate(lens):
            a = anc[i % 4]
            st = rng.integers(0, len(a) - n_bases + 1)
            s = a[st:st + n_bases].copy()
            m = rng.random(n_bases) < 0.01
            s[m] = rng.choice(alpha, int(m.sum()))
            f.write(b">r%d len=%d\n%s\n" % (i, n_bases, s.tobytes()))
    return str(path)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return write_records(tmp_path_factory.mktemp("lines") / "recs.fa")


@pytest.mark.parametrize("src,golden", [("multi.fa", "lines_fa_s5.gz"),
                                        ("tiny.fq", "lines_fq_s5.gz")])
def test_cli_lines_golden(tmp_path, src, golden, capsys):
    """-S 5 -i FILE -l FILE reproduces the reference binary's output."""
    out = tmp_path / "o.gz"
    rc = cli.main(["-S", "5", "-i", f"{FIXDIR}/{src}", "-l",
                   f"{FIXDIR}/{src}", "-O", str(out), "--device", "cpu"])
    assert rc == 0
    assert _gz(out) == _gz(f"{FIXDIR}/{golden}")
    capsys.readouterr()


@pytest.mark.parametrize("S", [8, 12])
def test_insert_file_lines_matches_jax(records, monkeypatch, S):
    """The -i index (matrix and header names) equals niqki_tpu's, chunked
    or not, with the long records on the device route or every record on
    it (NIQKI_TPU_HOST_READS=0)."""
    monkeypatch.delenv("NIQKI_TPU_HOST_READS", raising=False)
    jidx = JaxIndex(JaxParams(lF=S, min_fract=0.05))
    jidx.insert_file_lines(records)
    assert jidx.G == 100 and jidx.names[0] == ">r0 len=33000"
    p = SketchParams(lF=S, min_fract=0.05)
    idx = SketchIndex(p, device="cpu")
    assert idx.insert_file_lines(records) == list(range(100))
    assert idx.names == jidx.names
    np.testing.assert_array_equal(idx.matrix(), jidx.matrix())
    chunked = SketchIndex(p, device="cpu")
    chunked.insert_file_lines(records, chunk_records=37)
    np.testing.assert_array_equal(chunked.matrix(), jidx.matrix())
    monkeypatch.setenv("NIQKI_TPU_HOST_READS", "0")
    dev = SketchIndex(p, device="cpu")
    dev.insert_file_lines(records, chunk_records=37)
    assert dev.names == jidx.names
    np.testing.assert_array_equal(dev.matrix(), jidx.matrix())


def test_sketch_stream_routes_by_length(records, monkeypatch):
    """Only records over HOST_SKETCH_MAX reach the device dispatch, padded
    from LINES_MIN_PAD; a chunk of short records dispatches nothing."""
    from niqki_tpu_torch.ops import sketch
    seen = []
    orig = tindex.dispatch_sketch_packed_batch

    def spy(recs, p, device, **kw):
        seen.append(([r[1] for r in recs if r[1] > p.K], kw))
        return orig(recs, p, device, **kw)

    monkeypatch.setattr(tindex, "dispatch_sketch_packed_batch", spy)
    idx = SketchIndex(SketchParams(lF=8), device="cpu")
    parts = list(idx._sketch_stream(idx._iter_packed_with_headers(records),
                                    chunk_records=50))
    assert [len(part) for part, _ in parts] == [50, 50]
    assert seen == [(list(LONG), {"min_pad": 256})]
    assert sketch.padded_size(LONG[0], 256) == 1 << 16
    whole = SketchIndex(SketchParams(lF=8), device="cpu")
    whole.insert_file_lines(records)
    np.testing.assert_array_equal(
        np.stack([s for _, sks in parts for s in sks]), whole.matrix())


@pytest.mark.parametrize("S", [8, 12])
@pytest.mark.parametrize("binary", [False, True])
def test_cli_lines_matches_jax(records, tmp_path, monkeypatch, S, binary):
    """-i then -l through both CLIs: the same pretty and --binary-hits
    bytes. At S = 12 the counts take the bit-plane route (K2's plain
    version), forced at this small G by NIQKI_TPU_COUNT=bcount."""
    monkeypatch.chdir(tmp_path)
    args = ["-i", records, "-l", records, "-S", str(S), "-J", "0.05"]
    if binary:
        args.append("--binary-hits")
    assert jcli.main(args + ["-O", "j.gz"]) == 0
    calls = []
    if S == 12:
        monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
        orig = bcount.match_counts_planes
        monkeypatch.setattr(bcount, "match_counts_planes",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
    assert cli.main(args + ["-O", "t.gz", "--device", "cpu"]) == 0
    assert _gz("t.gz") == _gz("j.gz")
    assert b">r0 len=33000" in _gz("t.gz")
    assert len(calls) == (1 if S == 12 else 0)


def test_record_sketch_apis_match_jax(records):
    """sketch_packed_records (every record on the device route, whole-genome
    padding) and query_counts_stream equal niqki_tpu's."""
    p = SketchParams(lF=8, min_fract=0.05)
    idx = SketchIndex(p, device="cpu")
    idx.insert_file_lines(records)
    jidx = JaxIndex(JaxParams(lF=8, min_fract=0.05))
    jidx.insert_file_lines(records)
    recs = [r[1:] for r in idx._iter_packed_with_headers(records)][4:10]
    got = idx.sketch_packed_records(recs)
    np.testing.assert_array_equal(np.stack(got),
                                  np.stack(jidx.sketch_packed_records(recs)))
    assert idx.sketch_packed_records([]) == []
    streams = [ix.query_counts_stream(ix._iter_packed_with_headers(records),
                                      chunk_records=37)
               for ix in (idx, jidx)]
    n = 0
    for (part, c), (jpart, jc) in zip(*streams):
        assert [r[0] for r in part] == [r[0] for r in jpart]
        np.testing.assert_array_equal(c, jc)
        n += len(c)
    assert n == 100


@pytest.mark.parametrize("G,want", [(4096, 1 << 15), (16384, 1 << 14),
                                    (10 ** 6, 1 << 11)])
def test_query_file_lines_halves_batch(tmp_path, G, want):
    """query_file_lines halves its chunk while batch * G > 2^28, down to
    2^11 records (the bound on the dense (batch, G) counts)."""
    from niqki_tpu_torch import engine
    from niqki_tpu_torch.io.writers import GzTextWriter
    sizes = []

    class Index:
        backend, names, params = "torch", [], SketchParams(lF=8)

        def _iter_packed_with_headers(self, path):
            return iter(())

        def query_sketch_stream(self, rec_iter, batch):
            sizes.append(batch)
            return iter(())

    idx = Index()
    idx.G = G
    with GzTextWriter(str(tmp_path / "o.gz")) as out:
        engine.query_file_lines(idx, "unused.fa", out)
    assert sizes == [want]


def test_hits_from_counts_batch_matches_jax():
    """The one-argsort hit ranking equals niqki_tpu's on ties and
    sub-threshold counts."""
    rng = np.random.default_rng(5)
    c = rng.integers(0, 9, (37, 211)).astype(np.int32)
    for min_score in (0, 1, 5, 9):
        assert tindex.hits_from_counts_batch(c, min_score) == \
            jax_hits_batch(c, min_score)
        assert tindex.hits_from_counts_batch(c, min_score)[3] == \
            tindex.hits_from_counts(c[3], min_score)
    assert tindex.hits_from_counts_batch(np.zeros((2, 0), np.int32), 1) \
        == [[], []]


def test_numpy_backend_lines_matches_golden(tmp_path, capsys):
    """--backend numpy takes the per-record oracle route of -i and -l."""
    out = tmp_path / "o.gz"
    rc = cli.main(["-S", "5", "-i", f"{FIXDIR}/multi.fa", "-l",
                   f"{FIXDIR}/multi.fa", "-O", str(out), "--device", "cpu",
                   "--backend", "numpy"])
    assert rc == 0
    assert _gz(out) == _gz(f"{FIXDIR}/lines_fa_s5.gz")
    capsys.readouterr()


def test_missing_querylines_closes_output(tmp_path, capsys):
    """A missing -l file prints the message, closes -O as a valid empty
    gzip and returns 1."""
    o = tmp_path / "o.gz"
    rc = cli.main(["-l", str(tmp_path / "missing.fq"), "-O", str(o),
                   "--device", "cpu"])
    assert rc == 1
    assert _gz(o) == b""
    assert "Unable to open the file" in capsys.readouterr().out


def test_missing_indexlines_closes_output(tmp_path, capsys):
    o = tmp_path / "o.gz"
    rc = cli.main(["-i", str(tmp_path / "missing.fa"), "-O", str(o),
                   "--device", "cpu"])
    assert rc == 1
    assert _gz(o) == b""
    assert capsys.readouterr().out.count("Unable to open the file") == 1
