"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``niqki_tpu_torch/csrc/*.cu``. At first use they are
compiled with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface and loaded with ctypes. The library lives in
``build/niqki_tpu_torch/`` at the repository root, under a name that carries
a hash of the sources, so an edited source builds anew and an unchanged one
is reused. Nothing here runs at import: the CPU-only test machine imports
every module and has no ``nvcc``.

Each kernel wrapper (``ops.psort.sort_i32_pow2_batch``,
``ops.bcount._bcount_call``, ``ops.pcount._count_call``) adds one to
``LAUNCHES[name]`` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "niqki_tpu_torch")
SOURCES = ("psort.cu", "bcount.cu", "pcount.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

LAUNCHES = {"psort": 0, "bcount": 0, "pcount": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of niqki_tpu_torch "
                       "are built at first use and need the CUDA toolkit "
                       "(set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libniqki_kernels_{_source_hash()}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc`` per source, all started together, then one link. Returns
    the library's path; the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", o, os.path.join(CSRC_DIR, s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    steps = [(c, p.communicate()[0], p.returncode)
             for c, p in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", f"{tmp}.tmp", *objs]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        steps.append((link, res.stdout, res.returncode))
    with open(so[:-3] + ".log", "w") as f:
        for c, text, _ in steps:
            f.write(" ".join(c) + "\n" + text)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c, text, rc) for c, text, rc in steps if rc != 0]
    if failed:
        c, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{text}")
    os.replace(f"{tmp}.tmp", so)
    return so


def library():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.niqki_psort_i32.restype = i32
            lib.niqki_psort_i32.argtypes = [vp, vp, vp, vp, i64, i32, vp]
            lib.niqki_bcount.restype = i32
            lib.niqki_bcount.argtypes = [vp, vp, vp, i32, i32, i64, i64,
                                         i32, i64, i32, vp]
            lib.niqki_pcount.restype = i32
            lib.niqki_pcount.argtypes = [vp, vp, vp, i32, i64, i64, i32,
                                         i64, i32, vp]
            lib.niqki_cuda_error_string.restype = ctypes.c_char_p
            lib.niqki_cuda_error_string.argtypes = [i32]
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err:
        msg = library().niqki_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def stream_handle(t) -> int:
    """The raw cudaStream_t of the current stream on tensor ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t, name: str) -> None:
    """Wrappers run their plain version only for CPU tensors; anything else
    must be a CUDA tensor, which launches the kernel or raises."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}; the kernel takes "
                         "CUDA tensors and the plain version CPU tensors")
