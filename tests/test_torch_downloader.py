"""The port's streaming NCBI ingest (``-Iddl``) against niqki_tpu's, with
urlopen mocked (no test touches the network): the same names, in fof
order, and the same sketch matrix (tolerance 0), the reference's name and
flush quirks included.
"""

import gzip
import io
import os
import urllib.request

import numpy as np
import pytest

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import cli as jcli
from niqki_tpu import downloader as jdl
from niqki_tpu import native
from niqki_tpu.params import SketchParams as JaxParams
from niqki_tpu_torch import SketchIndex, SketchParams, cli, downloader

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")


def _seq(rng, n):
    return rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _serve(monkeypatch, assets):
    """Mock urlopen: <base>/<name>_genomic.fna.gz answers with the gzip
    bytes of assets[base]; any other base raises as a dead link does."""
    fetched = []

    def urlopen(url, timeout=None):
        fetched.append(url)
        base = url.rsplit("/", 1)[0]
        if base not in assets:
            raise OSError("404")
        return _Resp(assets[base])

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return fetched


def _assets(case):
    """(gzip bytes per accession base, fof lines) of one quirk case."""
    rng = np.random.default_rng(len(case))
    a, b, c = _seq(rng, 500), _seq(rng, 700), _seq(rng, 400)
    if case == "plain":          # a trailing dummy contig is dropped
        assets = {"https://x/acc1": b">c1\n" + a + b"\n>trailer\nACGT\n",
                  "https://x/acc2": b">c1\n" + b + b"\n>c2\n" + c
                                    + b"\n>t\nAC\n"}
        urls = ["https://x/acc1", "https://x/missing", "https://x/acc2"]
    elif case == "flush":        # single contig: nothing flushed, skipped;
        assets = {               # a contig <= K bases bleeds into the next
            "https://x/single": b">only\n" + a + b"\n",
            "https://x/multi": b">a\n" + a + b"\n>short\nACGTACGT\n>b\n" + b
                               + b"\n>trailer\nAC\n"}
        urls = ["https://x/single", "https://x/multi"]
    elif case == "members":      # two gzip members, lines wrapped at 60
        wrapped = b"\n".join(b[i:i + 60] for i in range(0, len(b), 60))
        urls = ["https://x/mem1", "x", "https://y/short/"]
        return ({"https://x/mem1": gzip.compress(b">a\n" + a + b"\n")
                 + gzip.compress(b">b\n" + wrapped + b"\n>c\n" + c)},
                urls)            # ... and no final newline
    else:
        raise ValueError(case)
    return {k: gzip.compress(v) for k, v in assets.items()}, urls


@pytest.mark.parametrize("url,name", [
    ("https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/000/005/845/"
     "GCF_000005845.2_ASM584v2", "GCF_000005845.2_ASM584v2"),
    ("https://x/GCF_1/", "GCF_1/"),            # the trailing slash is kept
    ("https://x/ab/c", "ab/c"),                # a slash in the last 3 chars
    ("noslash", "oslash"),                     # the first char is dropped
    ("ab", "b")])
def test_name_of_accession_url(url, name):
    assert downloader.name_of_accession_url(url) == name == \
        jdl.name_of_accession_url(url)


def test_name_of_accession_url_random_matches_jax():
    rng = np.random.default_rng(0)
    parts = ["GCF_000", "a", "x/y", "", "845", "ASM584v2", "ftp.x.gov"]
    for _ in range(300):
        n = int(rng.integers(1, 6))
        u = "/".join(parts[i] for i in rng.integers(0, len(parts), n))
        u = ("https://" if rng.integers(2) else "") + u + \
            ("/" if rng.integers(2) else "")
        assert downloader.name_of_accession_url(u) == \
            jdl.name_of_accession_url(u), u


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("case", ["plain", "flush", "members"])
def test_download_matches_jax(tmp_path, monkeypatch, case, backend):
    """The port's index after download_ncbi_fof equals niqki_tpu's (its
    oracle sketcher) after the same fetches: names in fof order, genomes,
    bases and the sketch matrix."""
    assets, urls = _assets(case)
    fetched = _serve(monkeypatch, assets)
    fof = tmp_path / "urls.txt"
    fof.write_text("".join(u + "\n" for u in urls))
    jidx = JaxIndex(JaxParams(lF=8, K=21), backend="numpy")
    want = jdl.download_ncbi_fof(jidx, str(fof), max_workers=2)
    n_jax = len(fetched)
    tidx = SketchIndex(SketchParams(lF=8, K=21), device="cpu",
                       backend=backend)
    got = downloader.download_ncbi_fof(tidx, str(fof), max_workers=3)
    assert fetched[n_jax:] and sorted(fetched[n_jax:]) == sorted(
        fetched[:n_jax])
    assert got == want and got[0] > 0
    assert tidx.names == jidx.names
    np.testing.assert_array_equal(tidx.matrix(), jidx.matrix())
    if case == "flush":
        assert tidx.names == ["https://x/multi"] and got[1] == 500 + 8 + 700


def test_cli_iddl_matches_jax(tmp_path, monkeypatch, capsys):
    """-Iddl <urls> -Q <fof> through both CLIs (fetches mocked): the same
    hit bytes; an unopenable -Iddl list prints the reference's message."""
    assets, urls = _assets("plain")
    _serve(monkeypatch, assets)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "urls.txt").write_text("".join(u + "\n" for u in urls))
    (tmp_path / "q.txt").write_text(f"{FIXDIR}/tiny1.fa\n")
    args = ["-Iddl", "urls.txt", "-Q", "q.txt", "-S", "8", "-K", "21"]
    assert jcli.main(args + ["-O", "j.gz"]) == 0
    assert cli.main(args + ["-O", "t.gz", "--device", "cpu"]) == 0
    with gzip.open("t.gz") as ft, gzip.open("j.gz") as fj:
        assert ft.read() == fj.read()
    out = capsys.readouterr().out
    assert "#genomes downloaded: 2 #bases downloaded: 1,600" in out
    assert cli.main(["-Iddl", "none.txt", "-O", "n.gz",
                     "--device", "cpu"]) == 0
    assert "Unable to open the file 'none.txt'" in capsys.readouterr().out
