#!/usr/bin/env python3
"""Time K2, the PyTorch/CUDA port's bit-plane count
(``niqki_tpu_torch.ops.bcount._bcount_call``), of one source tree on one
NVIDIA card, so that two trees can be compared in one run:

    python3 tools/torch_bcount_ab.py [--tree DIR] [--reps N] [--sweep-p]

DIR is the root of a checkout (default: the one holding this script); its
``niqki_tpu_torch`` builds its own kernels into ``DIR/build``. The inputs
are chip_smoke.py's (``bcount_inputs``, numpy seeds), so two trees count
the same planes: the -M shape (768 index rows re-encoded as queries
against 4096 rows of 1024 lanes, P = 13), the -Q shape (96 queries, P = 13
and 17) and 96 queries against 102,400 rows (the 4096 rows repeated 25
times). ``--sweep-p`` adds the -M shape at P = 3, 5, 9, 13 and 16 over
random planes: the slope of its time over P is the cost of a plane step,
the intercept what a (query, row, lane) costs beside its P XNOR-ANDs.

Prints one JSON line: the card, the tree, and per shape the median
milliseconds of ``--reps`` launches by CUDA events and a SHA-256 of the
counts. It fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep-p", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("torch_bcount_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(  # this checkout's smoke
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from niqki_tpu_torch import kernels
    from niqki_tpu_torch.ops import bcount
    if not kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"niqki_tpu_torch came from {kernels.__file__}, "
                           f"not from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t = time.time()
    kernels.library()
    build_s = time.time() - t

    def run(qp, xp):
        got = bcount._bcount_call(qp, xp)
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        ms = smoke.time_cuda(lambda: bcount._bcount_call(qp, xp),
                             reps=args.reps, warmup=3)
        return {"ms": ms, "sha256": digest[:16]}

    res = {}
    _, _, _, xp, qp = smoke.bcount_inputs(13)
    res["-M P=13"] = run(bcount._planes_as_queries(
        xp, 0, bcount.MATRIX_BLOCK).contiguous(), xp)
    res["-Q P=13"] = run(qp, xp)
    res["96 x 102,400 P=13"] = run(qp, xp.repeat(1, 25, 1))
    del xp, qp
    torch.cuda.empty_cache()
    _, _, _, xp, qp = smoke.bcount_inputs(17)
    res["-Q P=17"] = run(qp, xp)
    del xp, qp
    if args.sweep_p:
        gen = torch.Generator(device="cuda").manual_seed(5)
        for P in (3, 5, 9, 13, 16):
            xp = torch.randint(-2**31, 2**31 - 1, (P, smoke.G, 1024),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
            res[f"-M P={P} random"] = run(
                xp[:, :bcount.MATRIX_BLOCK].contiguous(), xp)
    print(json.dumps({"tree": os.path.relpath(tree, REPO), "card": card,
                      "torch": torch.__version__, "build_s": build_s,
                      "k2": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
