"""planes_s.<cell>: seconds of the index's plane build
(``ops.bcount.build_index_planes``, ending in a synchronize) per rebuild,
the mean over the window's rebuilds."""


def install(ctx):
    from niqki_tpu_torch.ops import bcount
    ctx.probes.wrap(bcount, "build_index_planes", "planes", sync=True)


def read(ctx):
    spans = ctx.probes.spans.get("planes", [])
    if not spans:
        return None
    return sum(s.seconds for s in spans) / len(spans)
