// K2: bit-plane fingerprint-match count.
//
//   counts[q, g] = sum_l popcount( AND_{p<P} ~(X[p, g, l] ^ Q[p, q, l]) )
//
// X is the index as P = W+1 bit-planes (W value planes and one validity
// plane), 32 fingerprints packed per uint32 lane; Q is a block of queries in
// the same layout. Replaces niqki_tpu/ops/bcount.py _bcount_call /
// _bcount_kernel (the Pallas kernel behind the matrix self-join and the -Q
// hit counts).
//
// What bounds it on the H100: the integer pipe. Each (q, g, lane) costs P
// XNOR-ANDs, one LOP3 each at 64 a clock per SM, and one popcount; the
// planes are bytes the card reads at 3.35 TB/s, far less than the LOP3 work
// at the self-join's shapes. What the design does about each limit:
//
// - Shared-memory loads. A block owns a 96-query x 128-row output tile
//   (192 threads, 12 along queries x 16 along rows) and each thread an
//   8 x 8 register tile of masks and counts. One plane step reads 8 query
//   and 8 row words with four 16-byte loads (4 consecutive queries or rows
//   each) for 64 LOP3s: 1 B of shared memory per LOP3. The 16 row-threads of
//   a warp read 256 consecutive bytes and its 2 query-threads broadcast, so
//   the loads use a small share of the shared-memory bandwidth.
// - Staging overlapped with compute. The lanes are walked in chunks of C
//   (4, or 2 when P > 16, so that two blocks fit on an SM at P <= 31).
//   While chunk k is counted, chunk k+1 is copied with cp.async, as it lies
//   in device memory ((plane, row) runs of C lanes), into a raw buffer; a
//   short shared-to-shared pass then transposes it lane-major (row index
//   fastest), which the 16-byte loads above need. The other block on the SM
//   counts through that pass. Rows past the ragged query and row edges are
//   filled with zeros by cp.async's source size and never stored.
// - X from device memory once. Blocks are numbered with the query tiles
//   fastest, so the blocks that share a row tile of X run together and the
//   query block (at most 41 MB at the -M shape) stays in the 50 MB L2.
// - The popcount. It issues to a pipe of 16 a clock per SM, beside the
//   LOP3s, so one per (q, g, lane) against P >= 2 LOP3s at 64 a clock can
//   partly hide under them. Harley-Seal carry-save adders would
//   trade it for two LOP3s on the limiting pipe per mask and need 64 more
//   registers per carried level, beyond the 168 a thread may hold with two
//   blocks on an SM, so the count is one __popc per mask.
// - Small grids. When the output tiles would not fill the card, the lane
//   axis is split across gridDim.y; each split adds its partial counts into
//   an output the caller zeroes, with integer atomicAdd (exact, in any
//   order). The launch plan (chunk, split) is ops/bcount.py _plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 96;
constexpr int kTileG = 128;
constexpr int kRows = kTileQ + kTileG;            // staged rows per plane
constexpr int kThreadsG = 16;                     // threads along rows
constexpr int kThreadsQ = kTileQ / 8;             // 12 along queries
constexpr int kThreads = kThreadsQ * kThreadsG;   // 192
constexpr int kBlocksPerSM = 2;

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         int bytes, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;    // 0: fill the destination with zeros
  if (bytes == 16)  // .cg (L2 only) takes 16-byte copies alone
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// raw[p][r][C] <- lanes [l0, l0 + C) of row r of plane p: rows [0, 96) are
// the queries q0.., rows [96, 224) the index rows g0..
template <int C>
__device__ __forceinline__ void stage(uint32_t* raw,
                                      const uint32_t* __restrict__ qp,
                                      const uint32_t* __restrict__ xp, int P,
                                      int Qb, int64_t G, int64_t L, int q0,
                                      int64_t g0, int64_t l0) {
  for (int it = threadIdx.x; it < P * kRows; it += kThreads) {
    const int p = it / kRows, r = it % kRows;
    const uint32_t* src;
    bool valid;
    if (r < kTileQ) {
      valid = q0 + r < Qb;
      src = qp + (int64_t(p) * Qb + (valid ? q0 + r : 0)) * L + l0;
    } else {
      const int64_t g = g0 + (r - kTileQ);
      valid = g < G;
      src = xp + (int64_t(p) * G + (valid ? g : 0)) * L + l0;
    }
    cp_async(raw + it * C, src, 4 * C, valid);
  }
  cp_async_commit();
}

// lane-major: t[(p * C + l) * kRows + r] <- raw[(p * kRows + r) * C + l]
template <int C>
__device__ __forceinline__ void transpose(uint32_t* t, const uint32_t* raw,
                                          int P) {
  for (int it = threadIdx.x; it < P * kRows; it += kThreads) {
    const int p = it / kRows, r = it % kRows;
    uint32_t v[C];
    if constexpr (C == 4) {
      const uint4 a = reinterpret_cast<const uint4*>(raw)[it];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
      const uint2 a = reinterpret_cast<const uint2*>(raw)[it];
      v[0] = a.x; v[1] = a.y;
    }
#pragma unroll
    for (int l = 0; l < C; ++l) t[(p * C + l) * kRows + r] = v[l];
  }
}

__device__ __forceinline__ void unpack(const uint4 a, const uint4 b,
                                       uint32_t (&v)[8]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One plane of one lane from the transposed chunk: thread (tq, tg)'s
// queries 4tq + {0..3}, 48 + 4tq + {0..3} and rows 4tg + {0..3},
// 64 + 4tg + {0..3}, four 16-byte loads.
__device__ __forceinline__ void load8(const uint32_t* row, int tq, int tg,
                                      uint32_t (&qv)[8], uint32_t (&xv)[8]) {
  const uint4* qrow = reinterpret_cast<const uint4*>(row);
  const uint4* xrow = reinterpret_cast<const uint4*>(row + kTileQ);
  unpack(qrow[tq], qrow[tq + kThreadsQ], qv);
  unpack(xrow[tg], xrow[tg + kThreadsG], xv);
}

template <int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bcount_kernel(const uint32_t* __restrict__ qp,
              const uint32_t* __restrict__ xp, int32_t* __restrict__ out,
              int P, int Qb, int64_t G, int64_t L, int n_qtiles,
              int64_t lanes_per_split) {
  extern __shared__ uint4 smem_words[];
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem_words);   // [P][kRows][C]
  uint32_t* t = raw + P * kRows * C;                         // [P][C][kRows]
  const int tg = threadIdx.x % kThreadsG;
  const int tq = threadIdx.x / kThreadsG;
  const int q0 = (blockIdx.x % n_qtiles) * kTileQ;
  const int64_t g0 = int64_t(blockIdx.x / n_qtiles) * kTileG;
  const int64_t lbeg = int64_t(blockIdx.y) * lanes_per_split;
  const int64_t lend =
      lbeg + lanes_per_split < L ? lbeg + lanes_per_split : L;
  const int64_t nchunks = (lend - lbeg) / C;

  stage<C>(raw, qp, xp, P, Qb, G, L, q0, g0, lbeg);
  cp_async_wait_all();
  __syncthreads();
  transpose<C>(t, raw, P);
  __syncthreads();
  if (nchunks > 1) stage<C>(raw, qp, xp, P, Qb, G, L, q0, g0, lbeg + C);

  int32_t acc[8][8] = {};
  for (int64_t k = 0; k < nchunks; ++k) {
#pragma unroll 1
    for (int l = 0; l < C; ++l) {
      // plane p of lane l: t + (p * C + l) * kRows, queries then rows
      const uint32_t* row = t + l * kRows;
      uint32_t m[8][8], qv[8], xv[8];
      load8(row, tq, tg, qv, xv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) m[i][j] = ~(xv[j] ^ qv[i]);
#pragma unroll 1
      for (int p = 1; p < P; ++p) {
        load8(row + p * (C * kRows), tq, tg, qv, xv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) m[i][j] &= ~(xv[j] ^ qv[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += __popc(m[i][j]);
    }
    if (k + 1 < nchunks) cp_async_wait_all();
    __syncthreads();            // t is free; chunk k+1 is in raw
    if (k + 1 < nchunks) {
      transpose<C>(t, raw, P);
      __syncthreads();          // raw is free; t holds chunk k+1
      if (k + 2 < nchunks)
        stage<C>(raw, qp, xp, P, Qb, G, L, q0, g0, lbeg + (k + 2) * C);
    }
  }

  // thread (tq, tg) owns queries 4tq + {0..3}, 48 + 4tq + {0..3} and rows
  // 4tg + {0..3}, 64 + 4tg + {0..3} of the tile
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + (i / 4) * (4 * kThreadsQ) + 4 * tq + i % 4;
    if (q >= Qb) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int64_t g = g0 + jh * (4 * kThreadsG) + 4 * tg;
      int32_t* o = out + int64_t(q) * G + g;
      const int32_t* a = &acc[i][4 * jh];
      if (split) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g + j < G) atomicAdd(o + j, a[j]);
      } else if (g + 3 < G && G % 4 == 0) {
        *reinterpret_cast<int4*>(o) = make_int4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g + j < G) o[j] = a[j];
      }
    }
  }
}

template <int C>
int launch(const void* qp, const void* xp, void* out, int P, int Qb,
           int64_t G, int64_t L, int64_t lanes_per_split, int split,
           cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * 2 * (size_t)P * kRows * C;
  cudaError_t err = cudaFuncSetAttribute(
      bcount_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Qb + kTileQ - 1) / kTileQ;
  const int64_t n_gtiles = (G + kTileG - 1) / kTileG;
  const dim3 grid((unsigned)(n_qtiles * n_gtiles), (unsigned)split);
  bcount_kernel<C><<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(qp), static_cast<const uint32_t*>(xp),
      static_cast<int32_t*>(out), P, Qb, G, L, n_qtiles, lanes_per_split);
  return cudaGetLastError();
}

}  // namespace

// qp: (P, Qb, L) uint32, xp: (P, G, L) uint32, out: (Qb, G) int32, all
// row-major and 16-byte aligned; L % 8 == 0. chunk (4 or 2 lanes),
// lanes_per_split (a multiple of 8) and split come from the wrapper's plan;
// with split > 1 the output must hold zeros. Returns cudaGetLastError().
extern "C" int niqki_bcount(const void* qp, const void* xp, void* out, int P,
                            int Qb, int64_t G, int64_t L, int chunk,
                            int64_t lanes_per_split, int split,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L % 8 || lanes_per_split % 8 || lanes_per_split <= 0 || split < 1 ||
      (split - 1) * lanes_per_split >= L || split * lanes_per_split < L)
    return cudaErrorInvalidValue;
  if (chunk == 4)
    return launch<4>(qp, xp, out, P, Qb, G, L, lanes_per_split, split, st);
  if (chunk == 2)
    return launch<2>(qp, xp, out, P, Qb, G, L, lanes_per_split, split, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* niqki_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
