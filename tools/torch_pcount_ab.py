#!/usr/bin/env python3
"""Time K3, the PyTorch/CUDA port's pair-packed count
(``niqki_tpu_torch.ops.pcount``), of one source tree on one NVIDIA card, so
that two trees can be compared in one run:

    python3 tools/torch_pcount_ab.py [--tree DIR] [--reps N] [--sass]
                                     [--tile-q T]

DIR is the root of a checkout (default: the one holding this script); its
``niqki_tpu_torch`` builds its own kernels into ``DIR/build``. The inputs
are chip_smoke.py's (``pcount_inputs``, numpy seeds), so two trees count
the same fingerprints at S = 10 (512 pair lanes) unless named:

- (a) 64 queries x 4096 rows, (b) 64 x 102,400 rows, (c) 64 x 4096 at
  S = 11 (1024 lanes): one ``_count_call`` each, timed by CUDA events;
- (d) 4096 queries x 4096 rows and (e) 96 x 4096: ``match_counts_packed``,
  the call that phase 6 (-M -S 10) and phase 7 (-I/-Q -S 10) of the smoke
  make, with the queries shipped from the host and the counts copied back,
  and the launches of K3 it makes.

Beside each time (CUDA events around one call, the host's share
included): ``device_ms``, the device time of K3's launches in that call
with the host's share left out (``chip_smoke.device_ms``); at (d) and (e)
it is that of the ``_count_call`` launches the call made, replayed back to
back, without the copies between host and card.

``--tile-q T`` forces the tree's query tile to T (``pcount.KERNEL_TILES_Q``
set to (T,)), to compare the tiles the plan picks from on one card.

``--sass`` adds, for the tree's K3 source, the opcode counts of its
compiled kernel (``cuobjdump -sass``), and a probe of the per-lane match
test alone: three forms (the earlier kernel's two compares, the SWAR
zero-halfword test, and min.u16x2) in an 8 x 8 register tile as the
kernels hold it, with their SASS instructions per (query, row, pair lane),
from the difference between 4 and 2 lanes a pass, so that the code around
the tile cancels. The probe is compiled, never run.

Prints, as its last line, one JSON object: the card, the tree, and per
shape the median milliseconds of ``--reps`` runs and a SHA-256 of the
counts. It fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t eq_two_compares(uint32_t z) {
  return uint32_t((z & 0xFFFFu) == 0u) + uint32_t((z >> 16) == 0u);
}
__device__ __forceinline__ uint32_t nz_swar(uint32_t z) {
  return ((((z & 0x7FFF7FFFu) + 0x7FFF7FFFu) | z) & 0x80008000u) >> 15;
}
__device__ __forceinline__ uint32_t nz_vmin(uint32_t z) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(z), "r"(0x00010001u));
  return r;
}

template <int FORM>
__device__ __forceinline__ uint32_t test(uint32_t z) {
  if (FORM == 0) return eq_two_compares(z);
  if (FORM == 1) return nz_swar(z);
  return nz_vmin(z);
}

// An 8 x 8 tile of counts over LANES lanes a pass, two lanes per add, as
// the kernels count; only its instructions are counted.
template <int FORM, int LANES>
__global__ void probe(const uint32_t* __restrict__ in, uint32_t* out,
                      int passes) {
  const uint32_t* p = in + (threadIdx.x & 7);
  uint32_t q[8][LANES], x[8][LANES], acc[8][8] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      q[i][l] = p[i * LANES + l];
      x[i][l] = p[64 + i * LANES + l];
    }
  for (int it = 0; it < passes; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        asm volatile("" : "+r"(q[i][l]), "+r"(x[i][l]));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int l = 0; l < LANES; l += 2)
          acc[i][j] += test<FORM>(q[i][l] ^ x[j][l]) +
                       test<FORM>(q[i][l + 1] ^ x[j][l + 1]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s += acc[i][j] * (i * 8 + j + 1);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template __global__ void probe<0, 2>(const uint32_t*, uint32_t*, int);
template __global__ void probe<0, 4>(const uint32_t*, uint32_t*, int);
template __global__ void probe<1, 2>(const uint32_t*, uint32_t*, int);
template __global__ void probe<1, 4>(const uint32_t*, uint32_t*, int);
template __global__ void probe<2, 2>(const uint32_t*, uint32_t*, int);
template __global__ void probe<2, 4>(const uint32_t*, uint32_t*, int);
"""
FORMS = ("two_compares", "swar", "min_u16x2")
NOT_COUNTED = re.compile(r"^(LD|ST|NOP|BRA|EXIT|S2R|S2UR|ULDC|CS2R|BAR)")


def sass_functions(binary: str,
                   cuobjdump: str) -> dict[str, collections.Counter]:
    """Opcode counts of each function in ``binary`` (cuobjdump -sass)."""
    text = subprocess.run([cuobjdump, "-sass", binary], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict[str, collections.Counter] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+"
                     r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur[m.group(1).split(".")[0]] += 1
    return funcs


def sass_report(kernels, build_dir: str) -> dict:
    """The K3 kernel's opcode counts and the per-lane test probe's SASS
    instructions per (query, row, pair lane)."""
    nvcc = kernels._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    funcs = sass_functions(kernels.library_path(), cuobjdump)
    k3 = {n: dict(c.most_common()) for n, c in funcs.items()
          if "pcount" in n}
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "pcount_probe.cu")
    cubin = os.path.join(build_dir, "pcount_probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    subprocess.run([nvcc, *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    funcs = sass_functions(cubin, cuobjdump)

    def counted(form, lanes):
        name = next(n for n in funcs if f"probeILi{form}ELi{lanes}E" in n)
        return collections.Counter({op: n for op, n in funcs[name].items()
                                    if not NOT_COUNTED.match(op)})

    probe = {}
    for form, name in enumerate(FORMS):
        diff = counted(form, 4)
        diff.subtract(counted(form, 2))
        pairs = 8 * 8 * 2                  # the 2 lanes more a pass
        per_pair = {op: n / pairs for op, n in diff.items() if n}
        probe[name] = {"sass_per_pair": sum(per_pair.values()),
                       "opcodes_per_pair": per_pair}
    return {"k3_kernel_opcodes": k3, "per_lane_test_probe": probe}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--tile-q", type=int)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_pcount_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(  # this checkout's smoke
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from niqki_tpu_torch import kernels
    from niqki_tpu_torch.ops import pcount
    require = smoke.require
    if not kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"niqki_tpu_torch came from {kernels.__file__}, "
                           f"not from {tree}")
    if args.tile_q:
        pcount.KERNEL_TILES_Q = (args.tile_q,)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t = time.time()
    kernels.library()
    build_s = time.time() - t

    def digest(a) -> str:
        data = np.ascontiguousarray(a).tobytes()
        return hashlib.sha256(data).hexdigest()[:16]

    def call(qp, xp):
        def fn():
            return pcount._count_call(qp, xp)
        return {"ms": smoke.time_cuda(fn, reps=args.reps, warmup=3),
                "device_ms": smoke.device_ms(fn, reps=args.reps),
                "plan": plan(qp, xp), "sha256": digest(fn().cpu().numpy())}

    def plan(qp, xp):
        if not hasattr(pcount, "_plan"):
            return None
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return pcount._plan(qp.shape[0], xp.shape[0], xp.shape[1], sms)

    def whole(q_np, gp, G):
        launched = []
        count_call = pcount._count_call

        def spy(qp, xp):
            launched.append((qp, xp))
            return count_call(qp, xp)
        kernels.reset_launches()
        pcount._count_call = spy
        try:
            got = pcount.match_counts_packed(q_np, gp, G)
        finally:
            pcount._count_call = count_call
        require(kernels.LAUNCHES["pcount"] == len(launched),
                "K3 launched outside _count_call")
        return {"ms": smoke.time_cuda(
                    lambda: pcount.match_counts_packed(q_np, gp, G),
                    reps=args.reps, warmup=3),
                "device_ms": smoke.device_ms(
                    lambda: [count_call(*a) for a in launched],
                    reps=args.reps),
                "launches": len(launched), "sha256": digest(got)}

    res = {}
    for key, Gx, S_ in (("a", smoke.G, 10), ("b", 102_400, 10),
                        ("c", smoke.G, 11)):
        _, _, qp, xp = smoke.pcount_inputs(Gx, S_, 64)
        res[f"({key}) 64 x {Gx}, S={S_}"] = call(qp, xp)
        del qp, xp
    torch.cuda.empty_cache()
    for key, Qb in (("d", smoke.G), ("e", smoke.NQ)):
        qd, _, _, xp = smoke.pcount_inputs(smoke.G, 10, Qb)
        res[f"({key}) match_counts_packed {Qb} x {smoke.G}, S=10"] = whole(
            qd.cpu().numpy(), xp, smoke.G)
        del qd, xp
    out = {"tree": os.path.relpath(tree, REPO), "card": card,
           "tile_q": args.tile_q,
           "torch": torch.__version__, "build_s": build_s, "k3": res}
    if args.sass:
        out["sass"] = sass_report(kernels,
                                  os.path.join(tree, "build", "pcount_probe"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
