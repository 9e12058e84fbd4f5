"""The all-vs-all matrix (``-M``): a closed loop, one caller, of
``engine.query_matrix(index, out)`` calls, as the CLI makes them, each the
whole Jaccard matrix of the index's G genomes, written through the port's
gzip writer (at its default level) into an in-memory sink. The index
holds the configuration's sketch rows (``sketchgen``) as a load or a
rebuild leaves them in memory (``SketchIndex.from_arrays``): the cell
measures the index against itself, never the sketcher.

End-to-end: ``query_genomes_per_s``. A matrix row is one index genome
queried against the whole index, so it is G rows of every call the
window started (the last runs to its end) over the time from the window's
start until the last call ended.

Check: every call's compressed bytes are equal (the first
``check_calls`` calls keep their bytes, the others only their SHA-256);
the first call's output, and any kept call's whose bytes differ from it,
is the header and G rows in index order, each of G values; its header and
``check_rows`` rows drawn from the seed, over all G columns, equal byte
for byte the plain reference's (``reference.matrix_header``,
``reference.matrix_row`` of ``reference.counts`` on the device).
"""

from __future__ import annotations

import hashlib
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import common, gen, sketchgen
from .. import reference as ref
from ..harness import Check, log


class _Digest(common.Sink):
    """A sink that keeps only the SHA-256 of the members written."""

    def __init__(self):
        super().__init__()
        self._h = hashlib.sha256()

    def write(self, b) -> int:
        self._h.update(b)
        self.nbytes += len(b)
        return len(b)

    def digest(self) -> str:
        return self._h.hexdigest()


def _rows(ctx) -> None:
    r = sketchgen.make_rows(ctx.config, ctx.seed, ctx.device)
    ctx.data["rows"], ctx.data["names"] = r.rows, r.names
    log(f"{r.G} sketch rows drawn")


def setup(ctx) -> None:
    from niqki_tpu_torch import SketchIndex
    _rows(ctx)
    common.reset_peak(ctx)
    ctx.state["index"] = SketchIndex.from_arrays(
        common.program_params(ctx.config), ctx.data["names"],
        ctx.data["rows"], device=ctx.device)
    _call(ctx, -1)          # warm-up: the planes, every shape of a call


def _call(ctx, i: int):
    """Call i of the window (-1: the warm-up); the first ``check_calls``
    keep their bytes."""
    from niqki_tpu_torch import engine
    w, sink = common.sink_writer()
    if not 0 <= i < ctx.traffic["check_calls"]:
        sink = w._f = _Digest()
    engine.query_matrix(ctx.state["index"], w)
    w.close()
    return sink


def window(ctx, seconds: float) -> dict:
    done, t0 = common.closed_loop(seconds, lambda i: _call(ctx, i))
    ctx.data["done"], ctx.data["t0"] = done, t0
    G = len(ctx.data["names"])
    ctx.attempted = len(done) * G
    return {"query_genomes_per_s": common.rate(G, done, t0)}


def _sampled(ctx) -> list:
    return common.sample(ctx.seed, range(len(ctx.data["names"])),
                         ctx.traffic["check_rows"])


def _reference_rows(ctx, ids, bits: int = 0) -> list:
    """The reference's matrix rows of genomes ``ids`` over all G columns
    (fingerprints ``bits`` narrower for the control), as bytes."""
    p = common.reference_params(ctx.config, bits)
    x = common.narrower(torch.from_numpy(ctx.data["rows"]).to(ctx.device),
                        bits)
    c = ref.counts(x[torch.as_tensor(ids, device=ctx.device)], x, p.W)
    del x
    names = ctx.data["names"]
    return [ref.matrix_row(names[g], c[k], p).encode()
            for k, g in enumerate(ids)]


def control(ctx, bits: int) -> None:
    """One call's output with the reference's rows at the sampled
    genomes and, at every other genome, its name and G zeros, which the
    check reads only for their place and width."""
    _rows(ctx)
    names = ctx.data["names"]
    ids = _sampled(ctx)
    got = dict(zip(ids, _reference_rows(ctx, ids, bits)))
    zeros = b"\t" + b"0\t" * len(names) + b"\n"
    text = b"".join([ref.matrix_header(names).encode()]
                    + [got.get(g) or n.encode() + zeros
                       for g, n in enumerate(names)])
    sink = common.Sink()
    sink.write(gen.zlib_member(text))
    ctx.data["done"] = [(0.0, 0.0, sink)]


def _inflate(member: bytes) -> bytes:
    out = []
    while member:
        d = zlib.decompressobj(31)
        out.append(d.decompress(member))
        if not d.eof:
            raise EOFError("a gzip member of the output is cut short")
        member = d.unused_data
    return b"".join(out)


def _text(sink) -> bytes:
    """A kept call's text: the writer's gzip members, one a part of the
    sink, inflated on a pool of threads."""
    with ThreadPoolExecutor(8) as pool:
        return b"".join(pool.map(_inflate, sink.parts))


def _row_spans(text: bytes) -> tuple[bytes, list]:
    """(the header line, the (start, end) of each row after it, its
    newline included)."""
    a = text.find(b"\n") + 1 or len(text)
    head, spans = text[:a], []
    while a < len(text):
        b = text.find(b"\n", a) + 1 or len(text)
        spans.append((a, b))
        a = b
    return head, spans


def _misplaced(text: bytes, spans: list, names) -> int:
    """Rows missing, extra, or not ``<name>\\t``, G values and a newline
    at their place."""
    G = len(names)
    bad = abs(len(spans) - G)
    for (a, b), n in zip(spans, names):
        bad += int(not text.startswith(n.encode() + b"\t", a, b)
                   or text.count(b"\t", a, b) != G + 1
                   or text[b - 1:b] != b"\n")
    return bad


def judge(ctx) -> list:
    names = ctx.data["names"]
    done = ctx.data["done"]
    digests = [sink.digest() for _, _, sink in done]
    differ = sum(int(d != digests[0]) for d in digests)
    header = ref.matrix_header(names).encode()
    kept, short, head_wrong = [], 0, 0
    # calls whose bytes equal the first call's hold its rows
    for (_, _, sink), d in zip(done, digests):
        if isinstance(sink, _Digest) or (kept and d == digests[0]):
            continue
        text = _text(sink)
        head, spans = _row_spans(text)
        head_wrong += int(head != header)
        short += _misplaced(text, spans, names)
        kept.append((text, spans))
    ids = _sampled(ctx)
    want = _reference_rows(ctx, ids)
    wrong = 0
    for k, (g, w) in enumerate(zip(ids, want)):
        text, spans = kept[k % len(kept)]
        wrong += int(g >= len(spans) or text[slice(*spans[g])] != w)
    ctx.failed = short
    return [Check("rows_missing_or_misplaced", short, 0),
            Check("header_wrong", head_wrong, 0),
            Check("repeat_calls_differing", differ, 0),
            Check("sampled_rows_wrong", wrong, 0)]

