"""SketchIndex on a torch device.

Subclass of ``niqki_tpu.index.SketchIndex``: the host side (fof handling,
native reader, densify, the dense (G, F) matrix, the formatters) is
inherited; the methods that reach the JAX package's device code are
overridden here with the torch ops of this package. The index's device is
explicit: ``SketchIndex(params, device)``, by default CUDA when present.
"""

from __future__ import annotations

import os
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from niqki_tpu import index as _base
from niqki_tpu import native, oracle
from niqki_tpu.io.fasta import read_records
from niqki_tpu.params import SketchParams

from .ops import bcount
from .ops.sketch import INT32_MAX, dispatch_sketch_packed_batch, pack_codes


def ensure_native() -> bool:
    """Load niqki_tpu's native host library, building it if needed.

    ``niqki_tpu.native`` runs ``make -C native`` at first use. The
    Makefile's libdeflate probe (``printf '\\#include <libdeflate.h>'``)
    keeps its backslash under GNU make 4.3+, so it passes where libdeflate
    is absent and the link then fails. When no library exists after that,
    build it once more without libdeflate (zlib only: the same decompressed
    bytes)."""
    if native.available():
        return True
    if os.path.exists(native._SO_PATH) or os.environ.get(
            "NIQKI_TPU_NO_NATIVE_BUILD") or os.environ.get("NIQKI_TPU_NO_NATIVE"):
        return False            # built but not loadable here, or opted out
    try:
        subprocess.run(["make", "-C", native._NATIVE_DIR, "-s",
                        "HAVE_DEFLATE=0"], capture_output=True, timeout=300,
                       check=False)
    except (OSError, subprocess.TimeoutExpired):
        return False            # no make: the pure-Python host paths serve
    native._tried = False       # let niqki_tpu.native load the fresh build
    return native.available()


def default_device() -> torch.device:
    """CUDA when torch sees a card, else the CPU (as JAX falls back to its
    CPU backend)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class SketchIndex(_base.SketchIndex):
    def __init__(self, params: SketchParams, device=None,
                 backend: str = "torch"):
        super().__init__(params, backend=backend)
        self.device = (torch.device(device) if device is not None
                       else default_device())
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SketchIndex on a CUDA device, but torch "
                               "sees no card")

    # ------------------------------------------------------------------
    # state carried over from the JAX package
    @classmethod
    def from_arrays(cls, params: SketchParams, names, mat: np.ndarray,
                    device=None) -> "SketchIndex":
        """An index holding ``names`` and the (G, F) int32 sketch matrix."""
        idx = cls(params, device=device)
        idx.names = list(names)
        idx._mat = np.ascontiguousarray(mat, np.int32)
        return idx

    @classmethod
    def from_jax(cls, jidx: _base.SketchIndex, device=None) -> "SketchIndex":
        """The same index as a ``niqki_tpu.SketchIndex`` (names + matrix)."""
        return cls.from_arrays(jidx.params, jidx.names, jidx.matrix(),
                               device=device)

    # ------------------------------------------------------------------
    # sketching
    def _device_tables(self, records) -> list:
        """Per-record device sketch tables as host arrays (None for records
        without k-mers), in record order."""
        rows: list = [None] * len(records)
        for chunk, dev in dispatch_sketch_packed_batch(records, self.params,
                                                       self.device):
            host = dev.cpu().numpy()
            for row, i in enumerate(chunk):
                rows[i] = host[row]
        return rows

    def sketch_records(self, seqs) -> np.ndarray:
        """Whole-file semantics: all records min-merge into one sketch
        (densified after each). Returns (F,) int32 with -1 empty."""
        p = self.params
        if self.backend == "numpy":
            return oracle.sketch_records(seqs, p)
        recs = [pack_codes(*oracle.encode_record(s, p.K), p.K) for s in seqs]
        return self._finalize_tables(self._device_tables(recs))

    def _load_packed(self, path: str):
        p = self.params
        try:
            if native.available():
                return [(w, n, e) for _, w, n, e
                        in native.read_packed_records(path, p.K)]
            return [pack_codes(*oracle.encode_record(s, p.K), p.K)
                    for _, s in read_records(path, p.K)]
        except (OSError, EOFError, zlib.error) as e:
            print(f"Warning: skipping unreadable file '{path}': {e}",
                  file=sys.stderr)
            return []

    def _finalize_tables(self, tables) -> np.ndarray:
        """Sequential per-record min-merge + densify (densified fillers of
        earlier records take part in later mins, as in the reference)."""
        sketch = np.full(self.params.F, -1, dtype=np.int32)
        for t in tables:
            if t is None:
                continue
            table = np.asarray(t)
            if table.dtype == np.int16:  # narrow wire, -1 sentinel
                table = np.where(table == -1, INT32_MAX,
                                 table.astype(np.int32))
            cur = np.where(sketch == -1, INT32_MAX, sketch)
            merged = np.minimum(cur, table)
            sketch = np.where(merged == INT32_MAX, -1, merged).astype(np.int32)
            _base._densify(sketch, self.params)
        return sketch

    def sketch_files(self, paths, window: int = 256,
                     io_threads: int | None = None) -> list[np.ndarray]:
        """Whole-file sketches for many files. The host route
        (NIQKI_TPU_SKETCH=host) is the parent's; the device route reads a
        window of files on a thread pool, sketches all its records in
        batches on the device (a window of 100 kb records stacks into
        batches of up to 256 rows of 2^17 bases), and collects the previous
        window's tables while the next one loads. NIQKI_TPU_WINDOW
        overrides ``window``."""
        paths = list(paths)
        if self.backend == "numpy" or self._host_sketch_route():
            return super().sketch_files(paths, io_threads=io_threads)
        env_w = os.environ.get("NIQKI_TPU_WINDOW")
        if env_w:
            window = max(1, int(env_w))
        out: list = [None] * len(paths)
        io_threads = io_threads or min(8, os.cpu_count() or 1)

        def collect(pend) -> None:
            w0, rec_counts, batches = pend
            rows: dict[int, np.ndarray] = {}
            for chunk, dev in batches:
                host = dev.cpu().numpy()
                for row, reci in enumerate(chunk):
                    rows[reci] = host[row]
            k = 0
            for fi, cnt in enumerate(rec_counts):
                out[w0 + fi] = self._finalize_tables(
                    [rows.get(k + ri) for ri in range(cnt)])
                k += cnt

        pending = None
        with ThreadPoolExecutor(max_workers=io_threads) as pool:
            def submit(w0):
                return (w0, [pool.submit(self._load_packed, pa)
                             for pa in paths[w0:w0 + window]])

            sub = submit(0) if paths else None
            while sub is not None:
                w0, futs = sub
                encs = [f.result() for f in futs]
                nxt = w0 + window
                sub = submit(nxt) if nxt < len(paths) else None
                records = [rec for recs in encs for rec in recs]
                batches = dispatch_sketch_packed_batch(records, self.params,
                                                       self.device)
                if pending is not None:
                    collect(pending)
                pending = (w0, [len(recs) for recs in encs], batches)
            if pending is not None:
                collect(pending)
        return out

    # Lines mode (-i/-l) and the multi-device layouts are later slices.
    def _not_ported(self, *_a, **_k):
        raise NotImplementedError("niqki_tpu_torch: lines mode and sharded "
                                  "serving are not ported yet")

    insert_file_lines = sketch_packed_records = _sketch_stream = _not_ported
    _sharded_for = _not_ported

    # ------------------------------------------------------------------
    # device copies of the index
    def _device_matrix(self) -> torch.Tensor:
        if self._device_mat is None:
            self._device_mat = torch.from_numpy(
                self._stored().astype(self._device_dtype)).to(self.device)
        return self._device_mat

    def _planes(self) -> torch.Tensor:
        """The (W+1, Gp, F/32) index bit-planes on the device (cached until
        the next insert)."""
        if self._device_planes is None:
            self._device_planes = bcount.build_index_planes(
                self._stored(), self.params.W, self.device, sanitized=True)
        return self._device_planes

    # ------------------------------------------------------------------
    # querying
    def counts(self, q_sketches: np.ndarray) -> np.ndarray:
        """Hit counts (Q, G) for a batch of query sketches (Q, F).

        Routes (NIQKI_TPU_COUNT = auto|host|bcount|xla): the native host
        count for G <= NIQKI_TPU_HOST_COUNT_G (default 2048) under auto; the
        bit-plane kernel K2 for G >= 4096 or when asked, under its shape
        gate; otherwise a plain torch blocked equality count. The JAX
        package's ``bcount-interpret`` means ``bcount`` here: on the CPU the
        kernel wrapper runs its plain version anyway."""
        raw = np.atleast_2d(np.asarray(q_sketches, np.int32))
        if self.G == 0 or self.backend == "numpy":
            return super().counts(raw)
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
        if mode in ("pcount", "mxu"):
            raise NotImplementedError(f"NIQKI_TPU_COUNT={mode}: that count "
                                      "route is not ported yet")
        host_max_g = int(os.environ.get("NIQKI_TPU_HOST_COUNT_G", "2048"))
        if native.available() and (
                mode == "host" or (mode == "auto" and self.G <= host_max_g)):
            return native.count_eq(np.ascontiguousarray(raw),
                                   self._stored_cached(),
                                   self.params.fingerprint_range)
        p = self.params
        q = self._query_side(raw)
        want_b = mode in ("bcount", "bcount-interpret") or self.G >= 4096
        if mode != "xla" and want_b and bcount.available(p.F, p.W):
            return bcount.match_counts_planes(q, self._planes(), self.G, p.W,
                                              sanitized=True)
        return self._counts_blocked(q)

    def _counts_blocked(self, q: np.ndarray) -> np.ndarray:
        """Plain torch equality count against the device matrix (the route
        for indexes outside the bit-plane gate, and NIQKI_TPU_COUNT=xla)."""
        mat = self._device_matrix()
        block = max(1, (1 << 26) // (self.G * self.params.F))
        qd = torch.from_numpy(q.astype(self._device_dtype)).to(self.device)
        out = torch.empty((len(q), self.G), dtype=torch.int32,
                          device=self.device)
        for lo in range(0, len(q), block):
            out[lo:lo + block] = (qd[lo:lo + block, None, :]
                                  == mat[None]).sum(-1, dtype=torch.int32)
        return out.cpu().numpy()

    def pretty_hits_batch(self, q_sketches: np.ndarray,
                          headers: list[str]) -> bytes | None:
        """Formatted pretty-hit rows through the sparse device path: per
        BLOCK_Q block, query pack + K2 count + top-k, so only surviving
        (count, gid) pairs come back. Byte-identical with
        HitsFormatter.format(counts(q), headers): rows whose survivors
        overflow the cap (NIQKI_TPU_HITS_CAP, default 2048) are re-fetched
        dense. Returns None when not eligible (callers use dense counts)."""
        p = self.params
        if (self.backend == "numpy" or not native.available()
                or p.min_score < 1 or not bcount.available(p.F, p.W)):
            return None
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
        if mode not in ("auto", "bcount", "bcount-interpret"):
            return None
        cap = min(self.G, int(os.environ.get("NIQKI_TPU_HITS_CAP", "2048")))
        if cap < 1 or self.G < 4096:
            return None
        raw = np.atleast_2d(np.asarray(q_sketches, np.int32))
        if len(raw) != len(headers):
            raise ValueError(f"{len(raw)} query sketches, {len(headers)} "
                             "headers")
        q = self._query_side(raw)
        xp = self._planes()
        vals, idx = bcount.match_counts_planes(
            q, xp, self.G, p.W, sanitized=True, topk=cap,
            min_score=p.min_score)
        over = (vals[:, -1] >= p.min_score) if cap < self.G else \
            np.zeros(len(vals), bool)

        def dense_fn(qq):
            return bcount.match_counts_planes(qq, xp, self.G, p.W,
                                              sanitized=True)

        return self._emit_sparse_rows(q, headers, vals, idx, over, dense_fn)
