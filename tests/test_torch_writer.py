"""GzTextWriter's members: streamed members of BLOCK input bytes, then the
tail cut at close into members of PIECE bytes and one shorter last member
(one member for an empty file). The member boundaries depend only on the
bytes written, so one write and many small writes of uneven size give the
same compressed bytes; through the native library and through zlib."""

from __future__ import annotations

import random
import zlib

import pytest

from niqki_tpu_torch import native
from niqki_tpu_torch.io.writers import GzTextWriter

BLOCK, PIECE = GzTextWriter.BLOCK, GzTextWriter.PIECE
SIZES = [0, 1, PIECE - 1, PIECE, PIECE + 1, BLOCK - 1, BLOCK,
         BLOCK + PIECE + 1]


def _text(n: int, seed: int) -> bytes:
    """``n`` bytes of hit rows: a query path, then name:jaccard pairs."""
    rng = random.Random(seed)
    rows, size = [], 0
    while size < n:
        hits = " ".join(f"/data/g{rng.randrange(102400)}.fa:"
                        f"{rng.randrange(1, 4096) / 4096:.6g}"
                        for _ in range(rng.randrange(1, 60)))
        row = f"/data/q{rng.randrange(9600)}.fa {hits} \n"
        rows.append(row)
        size += len(row)
    return "".join(rows).encode()[:n]


def _want_members(n: int) -> list[int]:
    """The input bytes of each member, as the rule cuts ``n`` bytes."""
    if n == 0:
        return [0]
    full, tail = divmod(n, BLOCK)
    return [BLOCK] * full + [min(PIECE, tail - lo)
                             for lo in range(0, tail, PIECE)]


def _members(raw: bytes) -> list[bytes]:
    """The decompressed bytes of each gzip member of ``raw``."""
    out = []
    while raw:
        d = zlib.decompressobj(31)
        out.append(d.decompress(raw) + d.flush())
        assert d.eof
        raw = d.unused_data
    return out


def _write(path, data: bytes, pieces) -> bytes:
    w = GzTextWriter(str(path))
    for lo, hi in pieces:
        w.write(data[lo:hi])
    w.close()
    with open(path, "rb") as f:
        return f.read()


def _uneven(n: int, seed: int) -> list[tuple[int, int]]:
    rng = random.Random(seed)
    cuts, lo = [], 0
    while lo < n:
        hi = min(n, lo + rng.choice((1, 7, 100, 4093, 65537, 300001)))
        cuts.append((lo, hi))
        lo = hi
    return cuts


@pytest.mark.parametrize("route", ["native", "zlib"])
@pytest.mark.parametrize("n", SIZES)
def test_close_cuts_the_tail_into_pieces(tmp_path, monkeypatch, route, n):
    """Decompressed bytes == the input; one write and many small uneven
    writes give the same compressed bytes; the members hold the rule's
    input bytes, each a gzip member of its slice at the writer's level."""
    monkeypatch.delenv("NIQKI_TPU_GZLEVEL", raising=False)
    if route == "native":
        if not native.available():
            pytest.skip("native lib unavailable")
    else:
        monkeypatch.setattr(native, "gzip_member", lambda d, lv: None)
    data = _text(n, seed=n)
    one = _write(tmp_path / "one.gz", data, [(0, n)])
    many = _write(tmp_path / "many.gz", data, _uneven(n, seed=n + 1))
    assert one == many
    members = _members(one)
    assert b"".join(members) == data
    assert [len(m) for m in members] == _want_members(n)
    lo, want = 0, []
    for size in _want_members(n):
        want.append(GzTextWriter._member(data[lo:lo + size], 6))
        lo += size
    assert one == b"".join(want)
