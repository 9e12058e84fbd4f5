// K3: pair-packed fingerprint-match count.
//
//   counts[q, g] = sum_f [Q[q, f] == X[g, f]]
//
// Fingerprints are int16 (W <= 14 bits plus the -2 / -3 sentinels) packed two
// per 32-bit lane, so each lane holds a pair; a half matches iff its 16 bits
// of x ^ q are zero. Q is the queries (Qb, Fp), X the index (G, Fp), Fp = F/2
// pair lanes. Replaces the JAX package's _count_call / _count_kernel in its
// ops/pcount.py (the Pallas kernel behind SketchIndex.counts when the
// bit-plane gate fails, i.e. S <= 11).
//
// What bounds it on the H100: the integer pipe. Each (q, g, pair lane) is an
// xor, a test of each half and an add, while X and Q are read from device
// memory about once, so the bytes are small beside the operations. What the
// design does about each limit:
//
// - Filling the card. The caller launches a whole count call as one grid
//   (ops/pcount.py match_counts_packed), not one 64-query block at a time.
//   Blocks are numbered with the query tiles fastest, so the blocks that
//   share a row tile of X run together and X streams from memory once.
//   When the output tiles would not fill the card (the -Q call's 96 queries
//   give 32 tiles), the lane axis is split across gridDim.y; each split adds
//   its partial counts into an output the caller zeroes, with integer
//   atomicAdd (exact, in any order). The plan is ops/pcount.py _plan.
// - Operands close to the ALUs. A 256-thread block owns a 128-query x
//   128-row output tile and each thread an 8 x 8 tile of counts in registers:
//   queries tq + 16i and rows tg + 16j. One step reads a 16-byte vector of 4
//   lanes of each of its 8 rows and 8 queries from shared memory: 16 loads
//   for 256 pair tests. Staging keeps device memory's row-major layout, rows
//   padded to 36 words, so the 8 threads of a quarter warp (rows r .. r+7)
//   hit 8 distinct 16-byte bank groups and the 16 threads that share a query
//   read one broadcast address: no transpose pass. Calls of 64 or 96
//   queries (the JAX package's block, the -Q block) would leave a 128-query
//   tile half or a quarter empty, so the tile is a template of 64, 96 or 128
//   queries (4, 6 or 8 a thread) and the plan takes the one that pads least.
//   On the H100 the 128 tile forced on such calls takes 1.26x the device
//   time at 96 queries and 1.7-1.9x at 64 (PERF.md, the K3 A/B tool's
//   --tile-q).
// - Loads overlapped with compute. Lanes come in chunks of 32; chunk k+1 is
//   copied with 16-byte cp.async into the second of two buffers while chunk
//   k is counted. The buffers take at most 73,728 bytes and the thread at
//   most 128 registers, so two blocks share an SM and each covers the
//   other's barriers.
// - The per-half test. The kernel counts nonzero halves: min.u16x2(q ^ x,
//   0x00010001) is one SIMD instruction (VIMNMX) on sm_90 and gives 1 in
//   each half that differs, and two lanes' results go into the
//   16-bit-per-half counters with one three-input add; matches = 2 x lanes -
//   nonzero halves. That is 2.5 SASS instructions per (query, row, pair
//   lane), against 8.4 for ((z & 0xFFFF) == 0) + ((z >> 16) == 0) and 5.0
//   for the SWAR zero-halfword test (the K3 A/B tool's --sass). A
//   16-bit counter holds at most one per lane, so a lane range is at most
//   32,768 lanes (the plan cuts longer lane axes).
//
// Ragged query and row edges are zero-filled by cp.async's source size and
// never stored, so any Qb and G work; Fp and each lane range must be a
// multiple of 32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileG = 128;
constexpr int kThreadsQ = 16;                      // threads along queries
constexpr int kThreadsG = 16;                      // threads along rows
constexpr int kThreads = kThreadsQ * kThreadsG;    // 256
constexpr int kPerG = kTileG / kThreadsG;          // 8 rows a thread
constexpr int kChunk = 32;                         // lanes per staged chunk
constexpr int kStride = kChunk + 4;                // words per staged row
constexpr int kVecs = kChunk / 4;                  // 16-byte copies a row
constexpr int64_t kLaneCap = 32768;                // 16-bit counters

// A block's query tile is 16 x kPerQ queries (64, 96 or 128) against
// kTileG rows; staged rows are the queries, then the index rows.
template <int kPerQ>
struct Tile {
  static constexpr int kTileQ = kThreadsQ * kPerQ;
  static constexpr int kRows = kTileQ + kTileG;
  static constexpr int kStageWords = kRows * kStride;
  static constexpr int kSmemBytes = 2 * kStageWords * 4;   // two buffers
  static_assert(kTileQ * kVecs % kThreads == 0, "whole staging steps");
  static_assert(kRows * kVecs % kThreads == 0, "whole staging steps");
};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;       // 0: fill the destination with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

// buf[r * kStride + l] <- lane l0 + l of query q0 + r (r < kTileQ) or of
// index row g0 + r - kTileQ, for l < 32; one commit group.
template <int kPerQ>
__device__ __forceinline__ void stage(uint32_t* buf,
                                      const uint32_t* __restrict__ qp,
                                      const uint32_t* __restrict__ xp, int Qb,
                                      int64_t G, int64_t Fp, int q0,
                                      int64_t g0, int64_t l0) {
  using T = Tile<kPerQ>;
#pragma unroll
  for (int k = 0; k < T::kRows * kVecs / kThreads; ++k) {
    const int it = threadIdx.x + k * kThreads;
    const int r = it / kVecs, c = it % kVecs;
    const uint32_t* src;
    bool valid;
    if (k < T::kTileQ * kVecs / kThreads) {       // r < kTileQ
      valid = q0 + r < Qb;
      src = qp + int64_t(valid ? q0 + r : 0) * Fp;
    } else {
      const int64_t g = g0 + (r - T::kTileQ);
      valid = g < G;
      src = xp + (valid ? g : 0) * Fp;
    }
    cp_async16(buf + r * kStride + 4 * c, src + l0 + 4 * c, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 1 in each 16-bit half of z that is nonzero, 0 where it is zero.
__device__ __forceinline__ uint32_t nonzero_halves(uint32_t z) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(z), "r"(0x00010001u));
  return r;
}

template <int kPerQ>
__global__ void __launch_bounds__(kThreads, 2)
pcount_kernel(const uint32_t* __restrict__ qp,
              const uint32_t* __restrict__ xp, int32_t* __restrict__ out,
              int Qb, int64_t G, int64_t Fp, int n_qtiles,
              int64_t lanes_per_split) {
  using T = Tile<kPerQ>;
  extern __shared__ uint4 smem_words[];
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem_words);
  const int tg = threadIdx.x % kThreadsG;
  const int tq = threadIdx.x / kThreadsG;
  const int q0 = int(blockIdx.x % n_qtiles) * T::kTileQ;
  const int64_t g0 = int64_t(blockIdx.x / n_qtiles) * kTileG;
  const int64_t lbeg = int64_t(blockIdx.y) * lanes_per_split;
  const int64_t lend =
      lbeg + lanes_per_split < Fp ? lbeg + lanes_per_split : Fp;
  const int nchunks = int((lend - lbeg) / kChunk);

  // nonzero halves of (query tq + 16i, row tg + 16j): low half in bits
  // 0-15, high half in bits 16-31
  uint32_t acc[kPerQ][kPerG] = {};
  stage<kPerQ>(bufs, qp, xp, Qb, G, Fp, q0, g0, lbeg);
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage<kPerQ>(bufs + ((k + 1) & 1) * T::kStageWords, qp, xp, Qb, G, Fp,
                   q0, g0, lbeg + int64_t(k + 1) * kChunk);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();                      // chunk k is in its buffer
    const uint32_t* qs = bufs + (k & 1) * T::kStageWords + tq * kStride;
    const uint32_t* xs =
        bufs + (k & 1) * T::kStageWords + (T::kTileQ + tg) * kStride;
#pragma unroll 1
    for (int v = 0; v < kChunk; v += 4) {
      uint4 xv[kPerG];
#pragma unroll
      for (int j = 0; j < kPerG; ++j)
        xv[j] = *reinterpret_cast<const uint4*>(
            xs + j * kThreadsG * kStride + v);
#pragma unroll
      for (int i = 0; i < kPerQ; ++i) {
        const uint4 qv = *reinterpret_cast<const uint4*>(
            qs + i * kThreadsQ * kStride + v);
#pragma unroll
        for (int j = 0; j < kPerG; ++j) {
          acc[i][j] += nonzero_halves(qv.x ^ xv[j].x) +
                       nonzero_halves(qv.y ^ xv[j].y);
          acc[i][j] += nonzero_halves(qv.z ^ xv[j].z) +
                       nonzero_halves(qv.w ^ xv[j].w);
        }
      }
    }
    __syncthreads();                      // the buffer may be refilled
  }

  const int32_t halves = int32_t(2 * (lend - lbeg));
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < kPerQ; ++i) {
    const int q = q0 + tq + i * kThreadsQ;
    if (q >= Qb) continue;
#pragma unroll
    for (int j = 0; j < kPerG; ++j) {
      const int64_t g = g0 + tg + j * kThreadsG;
      if (g >= G) continue;
      const int32_t c = halves - int32_t(acc[i][j] & 0xFFFFu) -
                        int32_t(acc[i][j] >> 16);
      int32_t* o = out + int64_t(q) * G + g;
      if (split)
        atomicAdd(o, c);
      else
        *o = c;
    }
  }
}

template <int kPerQ>
int launch(const void* qp, const void* xp, void* out, int Qb, int64_t G,
           int64_t Fp, int64_t lanes_per_split, int split,
           cudaStream_t st) {
  using T = Tile<kPerQ>;
  const int64_t n_qtiles = (Qb + T::kTileQ - 1) / T::kTileQ;
  const int64_t blocks = n_qtiles * ((G + kTileG - 1) / kTileG);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pcount_kernel<kPerQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks, (unsigned)split);
  pcount_kernel<kPerQ><<<grid, kThreads, T::kSmemBytes, st>>>(
      static_cast<const uint32_t*>(qp), static_cast<const uint32_t*>(xp),
      static_cast<int32_t*>(out), Qb, G, Fp, int(n_qtiles), lanes_per_split);
  return cudaGetLastError();
}

}  // namespace

// qp: (Qb, Fp) uint32, xp: (G, Fp) uint32, out: (Qb, G) int32, all row-major
// and 16-byte aligned; Fp % 32 == 0. tile_q (64, 96 or 128 queries a
// block), lanes_per_split (a multiple of 32, at most 32,768) and split come
// from the wrapper's plan; with split > 1 the output must hold zeros.
// Returns cudaGetLastError().
extern "C" int niqki_pcount(const void* qp, const void* xp, void* out, int Qb,
                            int64_t G, int64_t Fp, int tile_q,
                            int64_t lanes_per_split, int split,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Qb < 1 || G < 1 || Fp % kChunk || lanes_per_split % kChunk ||
      lanes_per_split <= 0 || lanes_per_split > kLaneCap || split < 1 ||
      split > 65535 || (split - 1) * lanes_per_split >= Fp ||
      split * lanes_per_split < Fp)
    return cudaErrorInvalidValue;
  if (tile_q == 128)
    return launch<8>(qp, xp, out, Qb, G, Fp, lanes_per_split, split, st);
  if (tile_q == 96)
    return launch<6>(qp, xp, out, Qb, G, Fp, lanes_per_split, split, st);
  if (tile_q == 64)
    return launch<4>(qp, xp, out, Qb, G, Fp, lanes_per_split, split, st);
  return cudaErrorInvalidValue;
}
