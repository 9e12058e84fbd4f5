"""NIQKI-compatible command line of the port.

The flag surface, usage text and operator messages are the JAX package's
(``niqki_tpu.cli``); the run uses the port's SketchIndex and engine for
-I, -M, -Q, -O, -S/-K/-W/-H/-J and -G. Flags whose paths are not ported yet
exit with an error naming them.

Run as ``python -m niqki_tpu_torch.cli`` or via ``niqki-tpu-torch``.
"""

from __future__ import annotations

import os
import sys
import time

from niqki_tpu.cli import USAGE, _openable, _print_logo, _row, build_parser
from niqki_tpu.io.writers import GzTextWriter
from niqki_tpu.params import SketchParams

from . import engine
from .index import SketchIndex, ensure_native

_NOT_PORTED = (("load", "-L"), ("dump", "-D"), ("indexlines", "-i"),
               ("querylines", "-l"), ("indexdownload", "-Iddl"),
               ("mesh", "--mesh"), ("profile", "--profile"),
               ("save_sharded", "--save-sharded"),
               ("load_sharded", "--load-sharded"))


def main(argv=None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    if not raw:
        print(USAGE, end="", file=sys.stderr)
        return 0
    parser = build_parser()
    parser.prog = "niqki-tpu-torch"
    args, extra = parser.parse_known_args(raw)
    if extra:
        for i, a in enumerate(extra):
            print(f"Non-option argument #{i} is {a}")
            print(f"Ignoring unknown argument '{a}'")
        print("Bad usage!!!")
        return 1
    if args.logo and len([a for a in raw if a]) == 1:
        _print_logo()
        return 0
    refused = [flag for attr, flag in _NOT_PORTED if getattr(args, attr)]
    if refused:
        print(f"niqki-tpu-torch: {', '.join(refused)} not ported yet "
              "(use niqki-tpu)", file=sys.stderr)
        return 2
    ensure_native()
    return _run_inner(args)


def _run_inner(args) -> int:
    params = SketchParams(lF=args.sketch, K=args.kmer, W=args.word,
                          H=args.HHL, min_fract=args.minjac)
    print("+-------------------------------------------------------------------+")
    print("|                            Informations                           |")
    print("+-----------------------------------+-------------------------------+")
    index = SketchIndex(params, backend="numpy" if args.backend == "numpy"
                        else "torch")
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

    t_indexed = time.time()
    print(_row("Indexing lasted (s)", f"{t_indexed - t_start:g}"))

    if args.matrix:
        matrix_ok = _openable(args.matrix)
        if not args.index:
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
