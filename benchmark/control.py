"""The control of a cell's check: the plain reference put in the program's
place with its fingerprints one bit narrower (W - 1 bits, the lowest bit
dropped, the step below the configuration's stated W that would tempt a
later change: one bit-plane fewer for K2), at the cell's own size. The
cell's loop fills the outputs a window would leave (``control``), and its
own ``judge`` decides ``correct``, as in a run (``harness.control_run``).
A sound check comes out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

It needs no program and no measured window: the benchmark's runs never
run it. The last line of standard output is a JSON object of each seed's
``correct`` and checks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = {}
    for s in args.seeds:
        t = time.time()
        res[s] = harness.control_run(args.workload, s, args.bits,
                                     device=args.device)
        print(f"control {args.workload} seed {s}: {res[s]} "
              f"({time.time() - t:.1f} s)", file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "bits": args.bits,
                      "readings": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
