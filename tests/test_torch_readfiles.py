"""A window of whole files read in one native call
(``native.read_packed_files``, ``SketchIndex._load_packed``): record for
record the per-file reader's wire (``native.read_packed_records``), the
JAX package's whole-file sketches and its skip warnings, ``sketch_file``
as the one-file case of ``sketch_files``, and the native thread count,
min(io_threads, files), as the ``index.read`` span reports it.
"""

import gzip
import os
import re

import numpy as np
import pytest

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu_torch import SketchIndex, SketchParams, debug, native

K = 21
LF = 10
WARNING = re.compile(r"^Warning: skipping unreadable file '(.*)': ",
                     re.MULTILINE)


@pytest.fixture(autouse=True)
def _native():
    if not native.available():
        pytest.skip("native library unavailable")
    debug.tracing(False)
    debug.spans()
    yield
    debug.tracing(False)
    debug.spans()


def _seq(rng, n: int, lower: float = 0.0, ns: float = 0.0) -> bytes:
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    arr[rng.random(n) < ns] = ord("N")
    low = rng.random(n) < lower
    arr[low] |= 0x20
    return arr.tobytes()


def _fasta(records) -> bytes:
    return b"".join(b">%s\n%s\n" % (h, s) for h, s in records)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every kind of input the reader meets, in one window: plain, gzip
    single- and multi-member, a record of at most K bases between longer
    ones, lowercase and N (rc exceptions), FASTQ by name, an empty file,
    a missing path, a truncated gzip (the reader keeps what inflated) and
    one with bytes after its member (the reader ignores them); the last
    two the batched read leaves to the per-file reader."""
    d = tmp_path_factory.mktemp("readfiles")
    rng = np.random.default_rng(20)
    out = {}

    def put(name, data):
        path = str(d / name)
        with open(path, "wb") as f:
            f.write(data)
        out[name] = path

    put("plain.fa", _fasta([(b"p", _seq(rng, 3000))]))
    put("single.fa.gz", gzip.compress(_fasta([(b"g", _seq(rng, 2500))])))
    put("multi_member.fa.gz",
        gzip.compress(_fasta([(b"m1", _seq(rng, 1800))]))
        + gzip.compress(_fasta([(b"m2", _seq(rng, 900))])))
    put("records.fa", _fasta([(b"r1", _seq(rng, 1200)),
                              (b"short", _seq(rng, K)),
                              (b"r3", _seq(rng, 2200))]))
    put("lower_n.fa", _fasta([(b"x", _seq(rng, 4000, 0.05, 0.01)),
                              (b"nstart", b"N" + _seq(rng, 800))]))
    put("reads.fq", b"".join(b"@q%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                             for i, s in enumerate(
                                 [_seq(rng, 150), _seq(rng, 20),
                                  _seq(rng, 300, 0.1)])))
    put("empty.fa", b"")
    whole = gzip.compress(_fasta([(b"t", _seq(rng, 20000))]))
    put("truncated.fa.gz", whole[:len(whole) // 2])
    put("tail.fa.gz", gzip.compress(_fasta([(b"z", _seq(rng, 700))]))
        + bytes(range(40)))
    out["missing.fa"] = str(d / "missing.fa")
    order = ["plain.fa", "single.fa.gz", "missing.fa", "multi_member.fa.gz",
             "records.fa", "empty.fa", "lower_n.fa", "reads.fq",
             "truncated.fa.gz", "tail.fa.gz"]
    return [out[n] for n in order]


def _assert_records_match(files, got):
    """got[i] equals read_packed_records' (words, n_bases, exc) of
    files[i] record for record, dtypes too, or its OSError; returns the
    number of records."""
    assert len(got) == len(files)
    n_records = 0
    for path, recs in zip(files, got):
        if not os.path.exists(path):
            assert isinstance(recs, OSError)
            assert str(recs) == f"cannot open {path}"
            with pytest.raises(OSError, match=re.escape(str(recs))):
                list(native.read_packed_records(path, K))
            continue
        want = [(w, n, e) for _, w, n, e
                in native.read_packed_records(path, K)]
        assert len(recs) == len(want), path
        for (gw, gn, ge), (ww, wn, we) in zip(recs, want):
            assert gw.dtype == np.uint32 and ge.dtype == np.int32
            assert gn == wn, path
            np.testing.assert_array_equal(gw, ww, err_msg=path)
            np.testing.assert_array_equal(ge, we, err_msg=path)
        n_records += len(recs)
    return n_records


@pytest.mark.parametrize("io_threads", [1, 8])
def test_records_match_the_per_file_reader(files, io_threads):
    """Each file's records, in order, equal read_packed_records' (words,
    n_bases, exc) with their dtypes, on one native thread and on eight; a
    file that cannot be opened comes back as read_packed_records'
    OSError."""
    got, threads = native.read_packed_files(files, K, io_threads)
    assert threads == io_threads
    n_records = _assert_records_match(files, got)
    # plain 1, gzip 1 + 2, records.fa 2 of 3, lower_n 2, FASTQ 2 of 3, the
    # truncated gzip's first part 1, the trailing bytes' 1: the short
    # records are dropped
    assert n_records == 12
    assert any(len(e) for recs in got if isinstance(recs, list)
               for _, _, e in recs)


@pytest.fixture(scope="module")
def jax_sketches(files):
    """The JAX package's sketches of the window, and the paths it warns
    about, once for the module."""
    import contextlib
    import io
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        want = JaxIndex(JaxParams(lF=LF, K=K)).sketch_files(files)
    return want, WARNING.findall(err.getvalue())


@pytest.mark.parametrize("io_threads", [1, 8])
@pytest.mark.parametrize("window", [256, 4])
def test_sketch_files_match_jax(files, jax_sketches, monkeypatch, capsys,
                                io_threads, window):
    """sketch_files' device route on the CPU, through the batched read, in
    one window and in windows smaller than the file count: the same
    sketches as the JAX package, and a skip warning for the same paths."""
    monkeypatch.setenv("NIQKI_TPU_SKETCH", "device")
    want, warned = jax_sketches
    assert warned == [p for p in files if not os.path.exists(p)]
    got = SketchIndex(SketchParams(lF=LF, K=K), device="cpu").sketch_files(
        files, window=window, io_threads=io_threads)
    assert WARNING.findall(capsys.readouterr().err) == warned
    assert len(got) == len(want)
    for path, g, w in zip(files, got, want):
        np.testing.assert_array_equal(g, w, err_msg=path)
    empty = np.full(1 << LF, -1, np.int32)
    for path, g in zip(files, got):
        if path.endswith(("missing.fa", "empty.fa")):
            np.testing.assert_array_equal(g, empty)
        else:
            assert (g >= 0).all(), path


@pytest.mark.parametrize("route", ["device", "host"])
def test_sketch_file_matches_sketch_files(files, jax_sketches, monkeypatch,
                                          route):
    """sketch_file is sketch_files' one-file case, on the device route and
    on the host sketcher: each readable file's sketch equals the JAX
    package's sketch_files row for it, the truncated gzip and the one with
    trailing bytes included (the native reader keeps what inflated, where
    Python's gzip raises); a path that cannot be opened raises OSError
    instead of being skipped."""
    monkeypatch.setenv("NIQKI_TPU_SKETCH", route)
    want, _ = jax_sketches
    idx = SketchIndex(SketchParams(lF=LF, K=K), device="cpu")
    for path, w in zip(files, want):
        if os.path.exists(path):
            np.testing.assert_array_equal(idx.sketch_file(path), w,
                                          err_msg=path)
        else:
            with pytest.raises(OSError, match=re.escape(path)):
                idx.sketch_file(path)


def _window(tmp_path, n: int):
    """n FASTA files of one 5 kb record."""
    rng = np.random.default_rng(n)
    paths = []
    for i in range(n):
        path = tmp_path / f"w{i}.fa"
        path.write_bytes(b">w%d\n%s\n" % (i, _seq(rng, 5000)))
        paths.append(str(path))
    return paths


def _read_span(paths, io_threads):
    debug.tracing(True)
    idx = SketchIndex(SketchParams(lF=LF, K=K), device="cpu")
    sks = idx.sketch_files(paths, io_threads=io_threads)
    spans = debug.spans()
    debug.tracing(False)
    read, = [s for s in spans if s.name == "index.read"]
    sk, = [s for s in spans if s.name == "index.sketch_files"]
    assert sk.counts["batched"] == sk.counts["files"] == len(paths)
    assert read.parent == sk.sid and read.tid == sk.tid
    return read, sks


def test_thread_count_follows_io_threads(tmp_path):
    """A window reads on min(io_threads, files) native threads, as the
    index.read span counts them: one where io_threads is one, one a file
    where the window has fewer files than io_threads; the sketches do not
    depend on it."""
    paths = _window(tmp_path, 10)
    one, sks1 = _read_span(paths, 1)
    assert one.counts == {"files": 10, "records": 10, "bases": 50000,
                          "threads": 1, "skipped": 0}
    eight, sks8 = _read_span(paths, 8)
    assert eight.counts["threads"] == 8
    three, _ = _read_span(paths[:3], 8)
    assert three.counts["threads"] == 3 and three.counts["files"] == 3
    for a, b in zip(sks1, sks8):
        np.testing.assert_array_equal(a, b)


def _ragged_text(rng, fastq: bool) -> bytes:
    """A file of random lines in the shapes a reader meets: headers, runs
    of sequence lines of any length (empty ones, lowercase, N, CR before
    the newline), a first line that is no header, no final newline; for
    FASTQ, four-line records and a cut last one."""
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtNn", np.uint8)

    def seq(n):
        return rng.choice(alphabet, n).tobytes()

    lines = []
    if fastq:
        for i in range(int(rng.integers(0, 8))):
            s = seq(int(rng.integers(0, 120)))
            lines += [b"@r%d " % i + seq(int(rng.integers(0, 40))), s,
                      b"+", b"I" * len(s)]
        lines = lines[:len(lines) - int(rng.integers(0, 4))]
    else:
        if rng.random() < 0.3:
            lines.append(seq(int(rng.integers(0, 40))))
        for i in range(int(rng.integers(0, 6))):
            lines.append(b">h%d" % i)
            for _ in range(int(rng.integers(0, 5))):
                lines.append(seq(int(rng.integers(0, 50))))
    lines = [ln + b"\r" if rng.random() < 0.05 else ln for ln in lines]
    text = b"\n".join(lines)
    return text + b"\n" if lines and rng.random() < 0.8 else text


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("fastq", [False, True])
def test_ragged_files_match_the_per_file_reader(tmp_path, fastq, gz):
    """80 files of random lines (_ragged_text), plain or gzipped, FASTA
    or FASTQ by name: in one window on four threads, each file's records
    equal read_packed_records'."""
    rng = np.random.default_rng([fastq, gz])
    paths = []
    for i in range(80):
        data = _ragged_text(rng, fastq)
        name = f"r{i}." + ("fq" if fastq else "fa") + (".gz" if gz else "")
        path = tmp_path / name
        path.write_bytes(gzip.compress(data) if gz else data)
        paths.append(str(path))
    got, threads = native.read_packed_files(paths, K, 4)
    assert threads == 4
    assert _assert_records_match(paths, got) > 20
