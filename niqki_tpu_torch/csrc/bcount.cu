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
// What bounds it on the H100: integer issue rate. Each (q, g, lane) costs P
// XNOR-ANDs (one LOP3 each) and one popcount, while the planes are read
// from device memory only once per block tile. The design therefore keeps
// operands close: a block owns a 32-query x 64-row output tile and walks
// the lanes in chunks of 8; each chunk's planes of both sides are staged in
// shared memory lane-major (the row or query index fastest, so a warp reads
// consecutive banks), and each thread keeps a 2-query x 4-row tile of AND
// masks and counts in registers, so one plane step is 6 shared loads for 8
// XNOR-ANDs. Ragged query and row edges are guarded, so any Qb and G work;
// the lane count must be a multiple of 8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 32;
constexpr int kTileG = 64;
constexpr int kLaneChunk = 8;
constexpr int kThreadsQ = 16;          // threads along queries
constexpr int kThreadsG = 16;          // threads along rows
constexpr int kPerThreadQ = kTileQ / kThreadsQ;   // 2
constexpr int kPerThreadG = kTileG / kThreadsG;   // 4
constexpr int kThreads = kThreadsQ * kThreadsG;   // 256

__global__ void bcount_kernel(const uint32_t* __restrict__ qp,
                              const uint32_t* __restrict__ xp,
                              int32_t* __restrict__ out, int P, int Qb,
                              int64_t G, int64_t L) {
  extern __shared__ uint32_t smem[];
  // qs[p][l][q] then xs[p][l][g]
  uint32_t* qs = smem;
  uint32_t* xs = smem + P * kLaneChunk * kTileQ;
  const int tid = threadIdx.x;
  const int tg = tid % kThreadsG;
  const int tq = tid / kThreadsG;
  const int64_t g0 = int64_t(blockIdx.x) * kTileG;
  const int q0 = blockIdx.y * kTileQ;

  int32_t acc[kPerThreadQ][kPerThreadG] = {};
  for (int64_t l0 = 0; l0 < L; l0 += kLaneChunk) {
    // stage the chunk: one (plane, row) run of 8 lanes per item
    for (int it = tid; it < P * kTileQ; it += kThreads) {
      const int p = it / kTileQ, q = it % kTileQ;
      uint32_t v[kLaneChunk];
      if (q0 + q < Qb) {
        const uint4* src = reinterpret_cast<const uint4*>(
            qp + (int64_t(p) * Qb + q0 + q) * L + l0);
        const uint4 a = src[0], b = src[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
        for (int l = 0; l < kLaneChunk; ++l) v[l] = 0;
      }
      for (int l = 0; l < kLaneChunk; ++l)
        qs[(p * kLaneChunk + l) * kTileQ + q] = v[l];
    }
    for (int it = tid; it < P * kTileG; it += kThreads) {
      const int p = it / kTileG, g = it % kTileG;
      uint32_t v[kLaneChunk];
      if (g0 + g < G) {
        const uint4* src = reinterpret_cast<const uint4*>(
            xp + (int64_t(p) * G + g0 + g) * L + l0);
        const uint4 a = src[0], b = src[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
        for (int l = 0; l < kLaneChunk; ++l) v[l] = 0;
      }
      for (int l = 0; l < kLaneChunk; ++l)
        xs[(p * kLaneChunk + l) * kTileG + g] = v[l];
    }
    __syncthreads();
    for (int l = 0; l < kLaneChunk; ++l) {
      uint32_t m[kPerThreadQ][kPerThreadG];
      for (int i = 0; i < kPerThreadQ; ++i)
        for (int j = 0; j < kPerThreadG; ++j) m[i][j] = 0xFFFFFFFFu;
      for (int p = 0; p < P; ++p) {
        const uint32_t* qrow = qs + (p * kLaneChunk + l) * kTileQ;
        const uint32_t* xrow = xs + (p * kLaneChunk + l) * kTileG;
        uint32_t qv[kPerThreadQ], xv[kPerThreadG];
        for (int i = 0; i < kPerThreadQ; ++i) qv[i] = qrow[tq + i * kThreadsQ];
        for (int j = 0; j < kPerThreadG; ++j) xv[j] = xrow[tg + j * kThreadsG];
        for (int i = 0; i < kPerThreadQ; ++i)
          for (int j = 0; j < kPerThreadG; ++j) m[i][j] &= ~(xv[j] ^ qv[i]);
      }
      for (int i = 0; i < kPerThreadQ; ++i)
        for (int j = 0; j < kPerThreadG; ++j) acc[i][j] += __popc(m[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < kPerThreadQ; ++i) {
    const int q = q0 + tq + i * kThreadsQ;
    if (q >= Qb) continue;
    for (int j = 0; j < kPerThreadG; ++j) {
      const int64_t g = g0 + tg + j * kThreadsG;
      if (g < G) out[int64_t(q) * G + g] = acc[i][j];
    }
  }
}

}  // namespace

// qp: (P, Qb, L) uint32, xp: (P, G, L) uint32, out: (Qb, G) int32, all
// row-major and 16-byte aligned; L % 8 == 0. Returns cudaGetLastError().
extern "C" int niqki_bcount(const void* qp, const void* xp, void* out, int P,
                            int Qb, int64_t G, int64_t L, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(uint32_t) * (size_t)P * kLaneChunk * (kTileQ + kTileG);
  cudaError_t err = cudaFuncSetAttribute(
      bcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((G + kTileG - 1) / kTileG),
                  (unsigned)((Qb + kTileQ - 1) / kTileQ));
  bcount_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(qp), static_cast<const uint32_t*>(xp),
      static_cast<int32_t*>(out), P, Qb, G, L);
  return cudaGetLastError();
}

extern "C" const char* niqki_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
