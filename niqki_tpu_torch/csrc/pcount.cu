// K3: pair-packed fingerprint-match count.
//
//   counts[q, g] = sum_f [Q[q, f] == X[g, f]]
//
// Fingerprints are int16 (W <= 14 bits plus the -2 / -3 sentinels) packed two
// per 32-bit lane, so each lane holds a pair; a half matches iff its 16 bits
// of x ^ q are zero. Q is a block of queries (Qb, Fp), X the index (G, Fp),
// Fp = F/2 pair lanes. Replaces niqki_tpu/ops/pcount.py _count_call /
// _count_kernel (the Pallas kernel behind SketchIndex.counts when the
// bit-plane gate fails, i.e. S <= 11).
//
// What bounds it on the H100: integer throughput. Each (q, g, pair lane)
// costs about four ALU operations (xor, a test of each half, the add), while
// X is read from device memory once per 64-query block, so the bytes are
// tiny beside the operations. The design keeps operands close: a block owns
// a 64-query x 64-row output tile and walks the lanes itself in chunks of
// 32; each chunk of both sides is staged in shared memory lane-major (the
// query or row index fastest, rows padded to 65 words so the staging stores
// and the inner-loop loads both hit 32 distinct banks), and each of the 256
// threads keeps a 4-query x 4-row tile of counts in registers, so one lane
// step is 8 shared loads for 16 pair compares. The per-half test is the
// plain form, ((z & 0xFFFF) == 0) + ((z >> 16) == 0) on unsigned z, not
// __vcmpeq2 + __popc. Ragged query and row edges are guarded, so any Qb and
// G work; Fp must be a multiple of 32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileG = 64;
constexpr int kLaneChunk = 32;
constexpr int kThreadsQ = 16;            // threads along queries
constexpr int kThreadsG = 16;            // threads along rows
constexpr int kPerThreadQ = kTileQ / kThreadsQ;   // 4
constexpr int kPerThreadG = kTileG / kThreadsG;   // 4
constexpr int kThreads = kThreadsQ * kThreadsG;   // 256
constexpr int kStride = 65;              // padded row count of a staged lane

// Stage rows [row0, row0 + 64) x lanes [l0, l0 + 32) of a (rows, Fp) array
// into dst[lane * kStride + row]; rows past the edge read as 0.
__device__ __forceinline__ void stage(const uint32_t* __restrict__ src,
                                      int64_t rows, int64_t row0, int64_t Fp,
                                      int64_t l0, uint32_t* dst, int tid) {
  constexpr int kVecPerRow = kLaneChunk / 4;
  for (int it = tid; it < 64 * kVecPerRow; it += kThreads) {
    const int r = it / kVecPerRow;
    const int c = it % kVecPerRow;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * Fp + l0 + 4 * c);
    dst[(4 * c + 0) * kStride + r] = v.x;
    dst[(4 * c + 1) * kStride + r] = v.y;
    dst[(4 * c + 2) * kStride + r] = v.z;
    dst[(4 * c + 3) * kStride + r] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads)
pcount_kernel(const uint32_t* __restrict__ qp, const uint32_t* __restrict__ xp,
              int32_t* __restrict__ out, int Qb, int64_t G, int64_t Fp) {
  __shared__ uint32_t qs[kLaneChunk * kStride];
  __shared__ uint32_t xs[kLaneChunk * kStride];
  const int tid = threadIdx.x;
  const int tg = tid % kThreadsG;
  const int tq = tid / kThreadsG;
  const int64_t g0 = int64_t(blockIdx.x) * kTileG;
  const int q0 = blockIdx.y * kTileQ;

  int32_t acc[kPerThreadQ][kPerThreadG] = {};
  for (int64_t l0 = 0; l0 < Fp; l0 += kLaneChunk) {
    stage(qp, Qb, q0, Fp, l0, qs, tid);
    stage(xp, G, g0, Fp, l0, xs, tid);
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kLaneChunk; ++l) {
      uint32_t qv[kPerThreadQ], xv[kPerThreadG];
#pragma unroll
      for (int i = 0; i < kPerThreadQ; ++i)
        qv[i] = qs[l * kStride + tq + i * kThreadsQ];
#pragma unroll
      for (int j = 0; j < kPerThreadG; ++j)
        xv[j] = xs[l * kStride + tg + j * kThreadsG];
#pragma unroll
      for (int i = 0; i < kPerThreadQ; ++i)
#pragma unroll
        for (int j = 0; j < kPerThreadG; ++j) {
          const uint32_t z = qv[i] ^ xv[j];
          acc[i][j] += int32_t((z & 0xFFFFu) == 0u) + int32_t((z >> 16) == 0u);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPerThreadQ; ++i) {
    const int q = q0 + tq + i * kThreadsQ;
    if (q >= Qb) continue;
#pragma unroll
    for (int j = 0; j < kPerThreadG; ++j) {
      const int64_t g = g0 + tg + j * kThreadsG;
      if (g < G) out[int64_t(q) * G + g] = acc[i][j];
    }
  }
}

}  // namespace

// qp: (Qb, Fp) uint32, xp: (G, Fp) uint32, out: (Qb, G) int32, all row-major
// and 16-byte aligned; Fp % 32 == 0, Qb <= 65535 * 64. Returns
// cudaGetLastError().
extern "C" int niqki_pcount(const void* qp, const void* xp, void* out, int Qb,
                            int64_t G, int64_t Fp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((G + kTileG - 1) / kTileG),
                  (unsigned)((Qb + kTileQ - 1) / kTileQ));
  pcount_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(qp), static_cast<const uint32_t*>(xp),
      static_cast<int32_t*>(out), Qb, G, Fp);
  return cudaGetLastError();
}
