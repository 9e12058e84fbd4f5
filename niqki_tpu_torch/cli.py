"""NIQKI-compatible command line of the port.

The counterpart of ``niqki_tpu/cli.py``, with the same flag surface, usage
text and operator messages; the run uses the port's SketchIndex and engine
for -I, -i, -Iddl, -M, -Q, -l, -D, -L, --save-sharded/--load-sharded
(--shards), --profile, --mesh, -O, -S/-K/-W/-H/-J and -G. It runs on the
card unless ``--device cpu`` is given, and raises when torch sees no card.
--mesh sets NIQKI_TPU_MESH for the run (``parallel.auto``).

Run as ``python -m niqki_tpu_torch.cli`` or via ``niqki-tpu-torch``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import engine, native
from .debug import profile
from .downloader import download_ncbi_fof
from .index import SketchIndex
from .io.writers import GzTextWriter
from .params import SketchParams

LOGO = r"""
     _   _ ___ ___  _  _____   _____ ____  _   _
    | \ | |_ _/ _ \| |/ /_ _| |_   _|  _ \| | | |
    |  \| || | | | | ' / | |    | | | |_) | | | |
    | |\  || | |_| | . \ | |    | | |  __/| |_| |
    |_| \_|___\__\_\_|\_\___|   |_| |_|    \___/
        TPU-native k-mer fingerprint indexing
"""


def _print_logo() -> None:
    """--logo: the reference reads ../resources/niqki.ascii relative to the
    CWD; when that file exists it is printed, otherwise the built-in
    banner."""
    try:
        with open("../resources/niqki.ascii") as f:
            print(f.read(), end="")
    except OSError:
        print(LOGO)


# Usage text mirroring the reference's usage table verbatim, quirks included
# (the --querylines row says -q although the parsed short flag is -l; -J's
# documented default 0.1 differs from the code's 0). Printed on -h/--help or
# on a bare invocation, to stderr.
USAGE = """
***Input***
  --index, -I <filename>        Input file of files to Index.

  --query, -Q <filename>        Input file of file to Query.

  --indexlines, -i <filename>   Query fa/fq file where each line is a separate
                                entry to Index

  --querylines, -q <filename>   Input fa/fq where each line is a separate entry
                                to Query

***Main parameters***
  --kmer, -K <int>              Kmer size (31).

  --sketch, -S <int>            Set sketch size to 2^S (15).

***Output***
  --output, -O <filename>       Output file (niqkiOutput.gz)
  --minjac, -J <int>            Minimal jaccard Index to report (0.1).

  --pretty, -P                  Print a human-readable outfile. By default the
                                outfile is in binary.
  --matrix, -M <filename>       Output the matrix distance to the given file.

***Advanced parameters*** (You know what you are doing)
  --word, -W <int>              Fingerprint size (12). Modify with caution,
                                larger fingerprints enable queries with less
                                false positive but increase EXPONENTIALY the
                                overhead as the index count S*2^W cells.

  --Genomes_sizes, -G <int>     Rought expectation of the genome sizes.

  --HHL, -H <int>               Size of the hyperloglog section (4).  Modify
                                with caution and prefer to use -G.

***Index files***
  --dump, -D <filename>         Dump the current index to the given file.
  --load, -L <filename>         Load an index to the given file.

***Other***
  --indexdownload, -Iddl <filename>
                                Get a list of NCBI accesion to download and to
                                put it in the index (experimental). This this
                                post to get such a list:
                                https://www.ncbi.nlm.nih.gov/genome/doc/ftpfaq/#allcomplete

  --logo                        Print ASCII art logo, then exit.
  --help, -h                    Print usage and exit.

***Additions of the PyTorch/CUDA port (niqki-tpu-torch)***
  --device <cuda|cpu>           Device to run on (default cuda).
  --backend <torch|numpy>       Compute backend (default torch).
  --binary-hits                 The reference's unreachable binary hit format.
  --save-sharded/--load-sharded <dir>, --shards <n>
                                Native sharded checkpoint format.
  --profile <dir>               Write a torch.profiler trace of the run.
  --mesh <DxT|auto|off>         Device mesh (NIQKI_TPU_MESH).
"""


class _UsageAction(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        print(USAGE, end="", file=sys.stderr)
        parser.exit(0)


def _openable(path: str) -> bool:
    """Reference-style operator error reporting: the reference checks each
    input with an ifstream and prints \"Unable to open the file '<f>'\"."""
    try:
        open(path, "rb").close()
        return True
    except OSError:
        print(f"Unable to open the file '{path}'")
        return False


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="niqki-tpu-torch", add_help=False,
        description="Genome-sketch index on PyTorch/CUDA (NIQKI-compatible "
                    "CLI)")
    g = ap.add_argument_group("Input")
    g.add_argument("-I", "--index", metavar="<file>",
                   help="Input file of files to Index.")
    g.add_argument("-Q", "--query", metavar="<file>",
                   help="Input file of files to Query.")
    g.add_argument("-i", "--indexlines", metavar="<file>",
                   help="fa/fq file where each line is a separate entry to Index")
    g.add_argument("-l", "--querylines", metavar="<file>",
                   help="fa/fq file where each line is a separate entry to Query")
    m = ap.add_argument_group("Main parameters")
    m.add_argument("-K", "--kmer", type=int, default=31, metavar="<int>",
                   help="Kmer size (31).")
    m.add_argument("-S", "--sketch", type=int, default=15, metavar="<int>",
                   help="Set sketch size to 2^S (15).")
    o = ap.add_argument_group("Output")
    o.add_argument("-O", "--output", default="niqkiOutput.gz",
                   metavar="<file>", help="Output file (niqkiOutput.gz)")
    o.add_argument("-J", "--minjac", type=float, default=0.0, metavar="<f>",
                   help="Minimal jaccard Index to report (0).")
    o.add_argument("-P", "--pretty", action="store_true",
                   help="Human-readable output (always on, as the reference).")
    o.add_argument("--binary-hits", action="store_true",
                   help="Binary hits output (the reference's unreachable "
                        "binary format).")
    o.add_argument("-M", "--matrix", metavar="<file>",
                   help="All-vs-all distance matrix for the given fof.")
    a = ap.add_argument_group("Advanced parameters")
    a.add_argument("-W", "--word", type=int, default=12, metavar="<int>",
                   help="Fingerprint size (12).")
    a.add_argument("-G", "--Genomes_sizes", type=int, default=0,
                   metavar="<int>", help="Rough expected genome size; "
                   "auto-tunes H.")
    a.add_argument("-H", "--HHL", type=int, default=4, metavar="<int>",
                   help="Hyperloglog section size (4); prefer -G.")
    f = ap.add_argument_group("Index files")
    f.add_argument("-D", "--dump", metavar="<file>",
                   help="Dump the index (NIQKI-compatible format).")
    f.add_argument("-L", "--load", metavar="<file>",
                   help="Load a dumped index.")
    f.add_argument("--save-sharded", metavar="<dir>",
                   help="Save the native sharded checkpoint.")
    f.add_argument("--load-sharded", metavar="<dir>",
                   help="Load a native sharded checkpoint.")
    f.add_argument("--shards", type=int, default=1,
                   help="Shard count for --save-sharded.")
    x = ap.add_argument_group("Other")
    x.add_argument("-Iddl", "--indexdownload", metavar="<file>",
                   help="List of NCBI accessions to download and index "
                        "(experimental; the reference's quirky -Iddl short "
                        "flag).")
    x.add_argument("--logo", action="store_true",
                   help="Print ASCII art logo, then exit.")
    x.add_argument("--backend", default="torch", choices=["torch", "numpy"],
                   help="Compute backend (default torch).")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on (default cuda; raises without a "
                        "card).")
    x.add_argument("--mesh", metavar="<DxT|auto|off>",
                   help="Device mesh: 'auto' (default; ('dp','tp') over "
                        "all cards when more than one), an explicit shape "
                        "like '2x4' (over NIQKI_TPU_VIRTUAL_DEVICES entries "
                        "where set), or 'off'. It spans every rank of a "
                        "torch.distributed group its caller initialized "
                        "(parallel.serving.init_distributed).")
    x.add_argument("--profile", metavar="<dir>",
                   help="Write a torch.profiler trace (Chrome/TensorBoard "
                        "*.pt.trace.json) of the run to this directory.")
    x.add_argument("-h", "--help", action=_UsageAction, nargs=0,
                   help="Print usage and exit.")
    return ap


def _row(label: str, value) -> str:
    return f"| {label:<34}|{str(value):>30} |"


def main(argv=None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    if not raw:
        print(USAGE, end="", file=sys.stderr)
        return 0
    args, extra = build_parser().parse_known_args(raw)
    if extra:
        for i, a in enumerate(extra):
            print(f"Non-option argument #{i} is {a}")
            print(f"Ignoring unknown argument '{a}'")
        print("Bad usage!!!")
        return 1
    if args.logo and len([a for a in raw if a]) == 1:
        _print_logo()
        return 0
    native.available()         # builds the native host library at first use
    with profile(args.profile, args.device):
        return _run(args)


def _run(args) -> int:
    """_run_inner with NIQKI_TPU_MESH set to --mesh for the run and
    restored after it."""
    if not args.mesh:
        return _run_inner(args)
    prev = os.environ.get("NIQKI_TPU_MESH")
    os.environ["NIQKI_TPU_MESH"] = args.mesh
    try:
        return _run_inner(args)
    finally:
        if prev is None:
            del os.environ["NIQKI_TPU_MESH"]
        else:
            os.environ["NIQKI_TPU_MESH"] = prev


def _run_inner(args) -> int:
    params = SketchParams(lF=args.sketch, K=args.kmer, W=args.word,
                          H=args.HHL, min_fract=args.minjac)
    print("+-------------------------------------------------------------------+")
    print("|                            Informations                           |")
    print("+-----------------------------------+-------------------------------+")
    if args.load:
        # the reference's load constructor takes min_score from the dump
        # and ignores -J; a missing dump crashes the reference, so it
        # prints the message and exits non-zero
        if not _openable(args.load):
            return 1
        index = SketchIndex.load(args.load, device=args.device,
                                 backend=args.backend)
    elif args.load_sharded:
        index = SketchIndex.load_sharded(args.load_sharded,
                                         device=args.device,
                                         backend=args.backend)
    else:
        index = SketchIndex(params, device=args.device, backend=args.backend)
    if args.Genomes_sizes:
        index.params = index.params.with_best_H(args.Genomes_sizes)
        print(f"I chosed H={index.params.H}")

    pretty = not args.binary_hits
    out = GzTextWriter(args.output)
    t_start = time.time()

    if args.index:
        if not _openable(args.index):
            print(f"Unable to open the file "
                  f"'{os.path.basename(args.index)}'")
            out.close()
            return 0
        engine.insert_fof_whole(index, args.index)
    if args.indexlines:
        if not _openable(args.indexlines):
            out.close()  # a closed, valid gzip, not a half-written one
            return 1     # the reference crashes here
        engine.insert_file_lines(index, args.indexlines)
    if args.indexdownload:
        if _openable(args.indexdownload):
            download_ncbi_fof(index, args.indexdownload)
    if args.dump:
        index.dump(args.dump)
    if args.save_sharded:
        index.save_sharded(args.save_sharded, args.shards)

    t_indexed = time.time()
    print(_row("Indexing lasted (s)", f"{t_indexed - t_start:g}"))

    if args.matrix:
        matrix_ok = _openable(args.matrix)
        # the reference indexes the matrix fof whenever -I and -i are
        # absent, on top of a loaded index too
        if not args.index and not args.indexlines:
            if not matrix_ok:
                print(f"Unable to open the file "
                      f"'{os.path.basename(args.matrix)}'")
                out.close()
                return 0
            t0 = time.time()
            engine.insert_fof_whole(index, args.matrix)
            print(_row("Indexing lasted (s)", f"{time.time() - t0:g}"))
        t0 = time.time()
        engine.query_matrix(index, out)
        print(_row("Query lasted (s)", f"{time.time() - t0:g}"))
    if args.query:
        if not _openable(args.query):
            out.close()
            return 1
        engine.query_fof_whole(index, args.query, out, pretty=pretty)
    if args.querylines:
        if not _openable(args.querylines):
            out.close()
            return 1     # the reference crashes here
        engine.query_file_lines(index, args.querylines, out, pretty=pretty)
    out.close()

    t_end = time.time()
    print(_row("Query lasted (s)", f"{t_end - t_indexed:g}"))
    print(_row("Whole run lasted (s)", f"{t_end - t_start:g}"))
    if args.logo:
        _print_logo()
        return 0
    print("+-----------------------------------+-------------------------------+")
    print(_row("k-mer size", args.kmer))
    print(_row("S", args.sketch))
    print(_row("Number of fingerprints", index.params.F))
    print(_row("W", args.word))
    print(_row("H", args.HHL))
    print(_row("Number of indexed genomes", index.G))
    print("+-----------------------------------+-------------------------------+")
    return 0


if __name__ == "__main__":
    sys.exit(main())
