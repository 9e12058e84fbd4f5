// K1: batched bitonic sort of int32 rows, N = 2^m elements per row.
//
// Replaces niqki_tpu/ops/psort.py sort_i32_pow2_batch (_local_sort_kernel,
// _cross_kernel, _merge_tail_kernel). On the sketch path it is the per-slot
// min reduction: the composite keys (slot << Wb) | fp of one record are
// sorted so that each slot's run head is its minimum fingerprint.
//
// What bounds it on the H100: device-memory traffic of the merge passes
// whose stride is at least one chunk (each reads and writes the whole batch
// once), and shared-memory bandwidth plus __syncthreads for the in-chunk
// stages. The design keeps every stage with a stride below 2^c inside one
// block's shared memory: one launch sorts each 2^c chunk completely (the
// first c rounds of the network), and after the global passes of round
// k > c one launch runs all c in-chunk stages of that round. A row of
// 2^17 keys thus costs 3 global passes plus 3 shared-memory launches
// instead of 153 passes over device memory. c <= 15 keeps a chunk within
// 128 KiB of dynamic shared memory.
//
// Network: the textbook bitonic sort. In round k (block size 2^k) at stride
// 2^j, element i is exchanged with i ^ 2^j, ascending iff bit k of the
// global index i is 0. Direction bits use the index within the row, so each
// row sorts independently and the last round (k = m) is ascending.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;

__device__ __forceinline__ void cmp_swap(int32_t& a, int32_t& b, bool asc) {
  const int32_t lo = min(a, b);
  const int32_t hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// One block per (row, chunk of 2^c). Loads the chunk from `in`, runs rounds
// k_lo..k_hi restricted to strides < 2^c, and stores it to `out` (which may
// alias `in`).
__global__ void bitonic_shared(const int32_t* in, int32_t* out,
                               int64_t n_row,
                               int c, int k_lo, int k_hi) {
  extern __shared__ int32_t s[];
  const int64_t chunk = int64_t(1) << c;
  const int64_t chunks_per_row = n_row >> c;
  const int64_t row = blockIdx.x / chunks_per_row;
  const int64_t base_in_row = (blockIdx.x % chunks_per_row) * chunk;
  const int64_t off = row * n_row + base_in_row;
  for (int64_t t = threadIdx.x; t < chunk; t += blockDim.x) s[t] = in[off + t];
  __syncthreads();
  const int64_t half = chunk >> 1;
  for (int k = k_lo; k <= k_hi; ++k) {
    for (int j = min(k, c) - 1; j >= 0; --j) {
      const int64_t stride = int64_t(1) << j;
      for (int64_t t = threadIdx.x; t < half; t += blockDim.x) {
        // insert a 0 bit at position j: the lower element of pair t
        const int64_t i = ((t >> j) << (j + 1)) | (t & (stride - 1));
        const bool asc = (((base_in_row + i) >> k) & 1) == 0;
        cmp_swap(s[i], s[i + stride], asc);
      }
      __syncthreads();
    }
  }
  for (int64_t t = threadIdx.x; t < chunk; t += blockDim.x) out[off + t] = s[t];
}

// One compare-exchange stage of round k at stride 2^j >= 2^c, in place,
// over all rows: one thread per pair.
__global__ void bitonic_global(int32_t* __restrict__ x, int64_t n_row,
                               int64_t total_pairs, int k, int j) {
  const int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total_pairs) return;
  const int64_t pairs_per_row = n_row >> 1;
  const int64_t row = p / pairs_per_row;
  const int64_t t = p % pairs_per_row;
  const int64_t stride = int64_t(1) << j;
  const int64_t i = ((t >> j) << (j + 1)) | (t & (stride - 1));
  const bool asc = ((i >> k) & 1) == 0;
  int32_t* r = x + row * n_row;
  int32_t a = r[i], b = r[i + stride];
  cmp_swap(a, b, asc);
  r[i] = a;
  r[i + stride] = b;
}

}  // namespace

// Sorts each row of `in` (rows x 2^log_n int32, row-major) ascending into
// `out`. chunk_log is the shared-memory chunk (<= 15, <= log_n).
// Returns cudaGetLastError() after the last launch.
extern "C" int niqki_psort_i32(const void* in, void* out, int64_t rows,
                               int log_n, int chunk_log, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = log_n;
  const int c = chunk_log;
  const int64_t n_row = int64_t(1) << m;
  const size_t smem = sizeof(int32_t) << c;
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks_shared = rows * (n_row >> c);
  const int half_chunk = 1 << (c - 1);
  const int threads_shared =
      half_chunk < kSharedThreads ? half_chunk : kSharedThreads;
  bitonic_shared<<<(unsigned)blocks_shared, threads_shared, smem, st>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n_row, c,
      1, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int32_t* x = static_cast<int32_t*>(out);
  const int64_t total_pairs = rows * (n_row >> 1);
  const unsigned blocks_global =
      (unsigned)((total_pairs + kGlobalThreads - 1) / kGlobalThreads);
  for (int k = c + 1; k <= m; ++k) {
    for (int j = k - 1; j >= c; --j) {
      bitonic_global<<<blocks_global, kGlobalThreads, 0, st>>>(
          x, n_row, total_pairs, k, j);
    }
    bitonic_shared<<<(unsigned)blocks_shared, threads_shared, smem, st>>>(
        x, x, n_row, c, k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
