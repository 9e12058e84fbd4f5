"""The port's index dumps (-D / -L) in the reference binary's format: the
goldens written byte for byte, dumps loaded equal to niqki_tpu's loader,
and the CLI's dump quirks held against niqki_tpu's CLI on the same inputs.
Tolerance 0: decompressed bytes and int32 matrices must be identical.
"""

import gzip
import os

import numpy as np
import pytest

from niqki_tpu import cli as jcli
from niqki_tpu import dumpfmt as jdumpfmt
from niqki_tpu import native
from niqki_tpu_torch import SketchIndex, cli, dumpfmt, engine
from niqki_tpu_torch import native as tnative
from niqki_tpu_torch.params import SketchParams

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FOF = f"{FIXDIR}/fof_tiny.txt"


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("flags,golden", [
    (["-S", "5"], "dump_tiny_s5.bin"),
    (["-S", "8", "-W", "10", "-H", "3"], "dump_tiny_s8w10h3.bin")])
def test_cli_dump_golden(tmp_path, flags, golden, capsys):
    """-I fof_tiny.txt -D writes the reference binary's dump (decompressed
    bytes)."""
    dump = tmp_path / "d.bin"
    rc = cli.main(["-I", FOF, *flags, "-D", str(dump),
                   "-O", str(tmp_path / "n.gz"), "--device", "cpu"])
    assert rc == 0
    assert _gz(dump) == _gz(f"{FIXDIR}/{golden}")
    capsys.readouterr()


@pytest.mark.parametrize("chunk_words", [1 << 24, 97])
def test_load_dump_matches_jax(tmp_path, chunk_words):
    """load_dump(dump_s10.bin) equals niqki_tpu's loader (header, matrix,
    names), also in odd 97-word chunks of the native scanner; saving what
    was loaded gives the fixture's bytes back."""
    path = f"{FIXDIR}/dump_s10.bin"
    hdr, mat, names = dumpfmt.load_dump(path, chunk_words=chunk_words)
    jhdr, jmat, jnames = jdumpfmt.load_dump(path)
    assert vars(hdr) == vars(jhdr)
    assert names == jnames and len(names) == hdr.genome_numbers
    np.testing.assert_array_equal(mat, jmat)
    assert (mat >= 0).all()                      # every slot densified
    p = hdr.params()
    assert (p.lF, p.K, p.W, p.H, p.min_score) == \
        (hdr.lF, hdr.K, hdr.W, hdr.H, hdr.min_score)
    out = tmp_path / "again.bin"
    dumpfmt.save_dump(str(out), p, mat, names)
    assert _gz(out) == _gz(path)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("golden", ["dump_tiny_s5.bin",
                                    "dump_tiny_s8w10h3.bin"])
def test_load_dump_routes_agree(monkeypatch, route, golden):
    """The streaming native load and the whole-buffer Python parse read the
    same matrix and names as niqki_tpu."""
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    hdr, mat, names = dumpfmt.load_dump(f"{FIXDIR}/{golden}")
    jhdr, jmat, jnames = jdumpfmt.load_dump(f"{FIXDIR}/{golden}")
    assert vars(hdr) == vars(jhdr) and names == jnames
    np.testing.assert_array_equal(mat, jmat)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("cut", [30, 1000])
def test_load_dump_truncated_raises(tmp_path, monkeypatch, route, cut):
    """A dump that ends inside its bucket stream raises ValueError instead
    of loading an index with missing fingerprints."""
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    raw = _gz(f"{FIXDIR}/dump_tiny_s5.bin")
    bad = tmp_path / "bad.bin"
    with gzip.open(bad, "wb") as f:
        f.write(raw[:-cut * 4 - 40])
    with pytest.raises(ValueError, match="truncated"):
        dumpfmt.load_dump(str(bad))


def test_save_empty_index_matches_jax(tmp_path):
    """An index of no genomes dumps as all-zero bucket sizes."""
    from niqki_tpu.params import SketchParams as JaxParams
    p = SketchParams(lF=5)
    dumpfmt.save_dump(str(tmp_path / "t.bin"), p,
                      np.zeros((0, p.F), np.int32), [])
    jdumpfmt.save_dump(str(tmp_path / "j.bin"), JaxParams(lF=5),
                       np.zeros((0, p.F), np.int32), [])
    assert _gz(tmp_path / "t.bin") == _gz(tmp_path / "j.bin")


def test_index_load_counts_match(tmp_path):
    """SketchIndex.load on the CPU holds the dump's params and matrix, and
    counts its own rows as the index it was dumped from."""
    idx = SketchIndex(SketchParams(lF=8, W=10, H=3, min_fract=0.05),
                      device="cpu")
    engine.insert_fof_whole(idx, FOF)
    idx.dump(str(tmp_path / "d.bin"))
    back = SketchIndex.load(str(tmp_path / "d.bin"), device="cpu")
    assert back.device.type == "cpu" and back.names == idx.names
    assert back.params.min_score == idx.params.min_score
    np.testing.assert_array_equal(back.matrix(), idx.matrix())
    np.testing.assert_array_equal(back.counts(idx.matrix()),
                                  idx.counts(idx.matrix()))


def _qfof(tmp_path):
    qfof = tmp_path / "q.txt"
    qfof.write_text("".join(f"{FIXDIR}/{n}\n" for n in
                            ("tiny2.fa", "multi.fa", "tiny1.fa")))
    return str(qfof)


def test_cli_dump_load_query_roundtrip(tmp_path, monkeypatch, capsys):
    """-I -D, then -L -Q: the same dump and hit bytes as niqki_tpu's CLI."""
    monkeypatch.chdir(tmp_path)
    qfof = _qfof(tmp_path)
    for mod, tag, extra in ((jcli, "j", []), (cli, "t", ["--device", "cpu"])):
        assert mod.main(["-I", FOF, "-S", "10", "-K", "21", "-D",
                         f"{tag}.bin", "-O", f"{tag}0.gz", *extra]) == 0
        assert mod.main(["-L", f"{tag}.bin", "-Q", qfof, "-O", f"{tag}.gz",
                         *extra]) == 0
    assert _gz("t.bin") == _gz("j.bin")
    assert _gz("t.gz") == _gz("j.gz")
    assert b"tiny2.fa:1 " in _gz("t.gz")
    capsys.readouterr()


def test_cli_load_then_matrix_reinserts_fof(tmp_path, monkeypatch, capsys):
    """-L + -M: the matrix fof is inserted into the loaded index (the
    reference checks only -I/-i), doubling the genome set."""
    monkeypatch.chdir(tmp_path)
    assert jcli.main(["-I", FOF, "-S", "10", "-D", "d.bin",
                      "-O", "n.gz"]) == 0
    assert jcli.main(["-L", "d.bin", "-M", FOF, "-O", "j.gz"]) == 0
    capsys.readouterr()
    assert cli.main(["-L", "d.bin", "-M", FOF, "-O", "t.gz",
                     "--device", "cpu"]) == 0
    got = _gz("t.gz")
    assert got == _gz("j.gz")
    assert got.split(b"\n")[0].count(b"tiny1.fa") == 2
    rows = capsys.readouterr().out.splitlines()
    assert "| Number of indexed genomes         |" \
        "                             6 |" in rows


def test_cli_load_ignores_minjac(tmp_path, monkeypatch, capsys):
    """-L takes min_score from the dump (built with -J 0.9) and ignores
    -J 0 on the command line."""
    monkeypatch.chdir(tmp_path)
    qfof = _qfof(tmp_path)
    assert cli.main(["-I", FOF, "-S", "10", "-K", "21", "-J", "0.9",
                     "-D", "d.bin", "-O", "n.gz", "--device", "cpu"]) == 0
    assert jcli.main(["-L", "d.bin", "-Q", qfof, "-J", "0", "-O",
                      "j.gz"]) == 0
    assert cli.main(["-L", "d.bin", "-Q", qfof, "-J", "0", "-O", "t.gz",
                     "--device", "cpu"]) == 0
    assert _gz("t.gz") == _gz("j.gz")
    assert cli.main(["-I", FOF, "-Q", qfof, "-S", "10", "-K", "21",
                     "-J", "0", "-O", "all.gz", "--device", "cpu"]) == 0
    assert len(_gz("t.gz")) < len(_gz("all.gz"))   # -J 0 was not used
    capsys.readouterr()


def test_cli_missing_dump_returns_1(tmp_path, capsys):
    rc = cli.main(["-L", str(tmp_path / "missing.bin"),
                   "-O", str(tmp_path / "o.gz"), "--device", "cpu"])
    assert rc == 1
    assert capsys.readouterr().out.count("Unable to open the file") == 1
