"""The port's sketch path (niqki_tpu_torch.ops.sketch / ops.psort) against
the JAX package on the same inputs, on the CPU.

The JAX side runs as its own tests run it: the hash family on uint32
pairs, the Pallas sort in interpret mode, the batched sketch through the
XLA-sort route. The port runs its plain versions (CPU tensors). All
comparisons are exact: the semantics are integer and bit-exact, so the
tolerance is 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from niqki_tpu import SketchIndex as JaxIndex
from niqki_tpu import oracle
from niqki_tpu.ops import psort as jpsort
from niqki_tpu.ops import sketch as jsketch
from niqki_tpu.ops import u32pair
from niqki_tpu.params import SketchParams
from niqki_tpu_torch import SketchIndex
from niqki_tpu_torch.ops import psort, sketch

FIX = "tests/fixtures"
M32 = 0xFFFFFFFF


def _values():
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, 1 << 63,
                     (1 << 64) - 1, (1 << 62) - 1], np.uint64)
    return np.concatenate([edge, rng.integers(0, 1 << 64, 4000,
                                              dtype=np.uint64)])


def _split(x):
    return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((x & np.uint64(M32)).astype(np.uint32)))


def _join(hi, lo):
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


@pytest.mark.parametrize("name", ["revhash64", "unrevhash64"])
def test_hash64_matches_u32pair(name):
    x = _values()
    want = _join(*getattr(u32pair, f"{name}_u32")(*_split(x)))
    got = getattr(sketch, name)(torch.from_numpy(x.view(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_clz64_matches_u32pair():
    x = _values()
    x = np.concatenate([x, x >> np.uint64(17), x >> np.uint64(40),
                        np.uint64(1) << np.arange(64, dtype=np.uint64)])
    want = np.asarray(u32pair.clz64_u32(*_split(x)))
    got = sketch.clz64(torch.from_numpy(x.view(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 64 and got[6] == 0   # clz64(0), clz64(2^64 - 1)


_PARAMS = {
    "golden": SketchParams(lF=15, K=31, W=12, H=4),
    "K2": SketchParams(lF=10, K=2),
    "K21_S16": SketchParams(lF=16, K=21),
    "stale_G": SketchParams(lF=12).with_best_H(5e6),
    "stale_G_carry": SketchParams(lF=12).with_best_H(1e9),   # H 4 -> 5
    "scatter": SketchParams(lF=15, K=31, W=16, H=4),
}


def _codes(rng, P, K):
    fwd = rng.integers(0, 4, P).astype(np.uint8)
    rc = (3 - fwd).astype(np.uint8)
    rc[rng.choice(np.arange(K, P), 40, replace=False)] = 0   # exceptions
    return fwd, rc


@pytest.mark.parametrize("case", list(_PARAMS))
def test_slot_fp_and_keys_match_jax(case):
    p = _PARAMS[case]
    rng = np.random.default_rng(len(case))
    P, nk = 2048, 1900                # windows beyond nk are padding
    fwd, rc = _codes(rng, P, p.K)
    kw = dict(lF=p.lF, K=p.K, W=p.W, H=p.H, mask_M=p.mask_M,
              max_rem=p.maximal_remainder)
    js, jf = jsketch._slot_fp_core(jnp.asarray(fwd), jnp.asarray(rc),
                                   jnp.int32(nk), **kw)
    ts, tf = sketch._slot_fp_core(torch.from_numpy(fwd)[None],
                                  torch.from_numpy(rc)[None],
                                  torch.tensor([nk], dtype=torch.int32), **kw)
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    assert (tf[0, nk:] == sketch.INT32_MAX).all()
    Wb = sketch._fp_bits(p.W, p.H, p.mask_M, p.maximal_remainder)
    assert Wb == jsketch._fp_bits(p.W, p.H, p.mask_M, p.maximal_remainder)
    if p.lF + Wb <= 30:
        jk = jsketch._keys_core(jnp.asarray(fwd), jnp.asarray(rc),
                                jnp.int32(nk), **kw)
        tk = sketch._keys_core(torch.from_numpy(fwd)[None],
                               torch.from_numpy(rc)[None],
                               torch.tensor([nk], dtype=torch.int32), **kw)
        np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk))
    else:
        assert case == "scatter"


def test_stale_constants_take_the_add_carry():
    """The -G case really overlaps mantissa mask and shifted exponent."""
    p = _PARAMS["stale_G_carry"]
    assert p.H == 5 and p.mask_M & ((1 << p.M) * p.maximal_remainder) != 0


@pytest.mark.parametrize("m,chunk_log", [(10, 10), (12, 10), (13, 11)])
def test_sort_plain_matches_pallas(m, chunk_log):
    rng = np.random.default_rng(m)
    x = rng.integers(-2**31, 2**31, (2, 1 << m)).astype(np.int32)
    x[1, ::3] = 7                               # duplicates
    want = np.asarray(jpsort.sort_i32_pow2_batch(
        jnp.asarray(x), interpret=True, chunk_log=chunk_log))
    got = psort.sort_i32_pow2_batch(torch.from_numpy(x), chunk_log=chunk_log)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_rejects_bad_shapes():
    with pytest.raises(ValueError):
        psort.sort_i32_pow2_batch(torch.zeros((1, 3000), dtype=torch.int32))
    with pytest.raises(ValueError):
        psort.sort_i32_pow2_batch(torch.zeros((1, 512), dtype=torch.int32))
    with pytest.raises(ValueError):
        psort.sort_i32_pow2_batch(torch.zeros((1, 1024), dtype=torch.int64))


def _random_fasta(path, seed):
    """Records with N runs, lowercase bases and IUPAC codes (the exception
    list), one shorter than K, one spanning two length buckets."""
    rng = np.random.default_rng(seed)
    recs = []
    for i, n in enumerate((5000, 20, 17000, 900)):
        s = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
        for _ in range(3):
            a = int(rng.integers(0, n - 1))
            run = len(s[a:a + int(rng.integers(1, 40))])
            s[a:a + run] = b"N" * run
        low = rng.random(n) < 0.05
        arr = np.frombuffer(bytes(s), np.uint8).copy()
        arr[low] = np.frombuffer(bytes(s), np.uint8)[low] | 0x20
        arr[rng.random(n) < 0.002] = ord("R")
        recs.append(b">r%d\n%s\n" % (i, arr.tobytes()))
    with open(path, "wb") as f:
        f.write(b"".join(recs))
    return str(path)


@pytest.mark.parametrize("pkey", ["small", "golden", "scatter"])
def test_sketch_files_match_jax(tmp_path, monkeypatch, pkey):
    """Whole-file sketches (device batch + per-record min-merge + densify)
    equal niqki_tpu's device route on the same files."""
    monkeypatch.setenv("NIQKI_TPU_SKETCH", "device")
    p = {"small": SketchParams(lF=12, K=21),
         "golden": SketchParams(),
         "scatter": SketchParams(lF=15, W=16)}[pkey]
    paths = [f"{FIX}/tiny1.fa", f"{FIX}/tiny2.fa", f"{FIX}/tiny3.fa",
             f"{FIX}/multi.fa", _random_fasta(tmp_path / "r.fa", 3)]
    want = JaxIndex(p).sketch_files(paths)
    got = SketchIndex(p, device="cpu").sketch_files(paths)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert all((g >= 0).all() for g in got)     # densified


def test_sketch_records_matches_oracle():
    p = SketchParams(lF=10, K=21)
    rng = np.random.default_rng(9)
    seqs = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), n).tobytes()
            for n in (3000, 10, 1500)]
    got = SketchIndex(p, device="cpu").sketch_records(seqs)
    np.testing.assert_array_equal(got, oracle.sketch_records(seqs, p))


def test_batch_grid_and_i16_wire():
    """dispatch_sketch_packed_batch pads rows to the {2^k, 3*2^(k-1)} grid,
    skips records without k-mers, and narrows to int16 when fingerprints
    fit 14 bits."""
    p = SketchParams(lF=10, K=21)
    rng = np.random.default_rng(2)
    recs = [sketch.pack_codes(*oracle.encode_record(
        rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes(), p.K), p.K)
        for n in (1000, 1200, 15, 900, 800)]
    out = sketch.dispatch_sketch_packed_batch(recs, p, torch.device("cpu"))
    assert len(out) == 1
    chunk, dev = out[0]
    assert chunk == [0, 1, 3, 4] and dev.shape == (4, p.F)
    assert dev.dtype == torch.int16
    out = sketch.dispatch_sketch_packed_batch(recs[:3], p,
                                              torch.device("cpu"))
    assert out[0][1].shape[0] == 2
