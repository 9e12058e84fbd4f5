// K1: batched ascending sort of int32 rows, N = 2^m keys per row, as a
// segmented LSD radix sort.
//
// Replaces niqki_tpu/ops/psort.py sort_i32_pow2_batch (_local_sort_kernel,
// _merge_tail_kernel, _cross_kernel). On the sketch path it is the per-slot
// min reduction: the composite keys (slot << Wb) | fp of one record are
// sorted so that each slot's run head is its minimum fingerprint.
//
// What bounds it on the H100: device-memory bytes. A radix sort needs no
// comparison network and does a fixed amount of work per key whatever N is:
// four passes of 8-bit digits (shifts 0, 8, 16, 24) over u = x ^ 0x80000000,
// whose unsigned order is x's signed order. Each pass is three launches:
//   radix_hist     one block per tile of T = min(N, 4096) keys of one row
//                  (256 threads x T/256 keys, 16-byte loads) counts the
//                  tile's digits into hist[row][digit][tile];
//   radix_scan     one warp per (row, digit) turns that digit's tile counts
//                  into exclusive offsets and leaves the digit's row total in
//                  the slot of tile 0, whose offset is always 0;
//   radix_scatter  reloads its tile, ranks its keys stably within the tile,
//                  reorders the tile by digit in shared memory and writes
//                  each digit's run to base[digit] + offset[digit][tile] +
//                  rank, neighbouring threads to neighbouring addresses.
// A pass thus moves 12 bytes a key (a read in hist, a read and a write in
// scatter), the sort 48, against the 8 of one read and one write; the rest
// of the design keeps every access coalesced and every block busy. Tiles
// never cross a row (N and T are powers of two); indices are 32-bit within a
// row and 64-bit only for the row's base.
//
// Ranking: warp w owns the tile's keys [w * T/8, (w + 1) * T/8), lane l
// holding key w * T/8 + k * 32 + l in round k. Eight ballots, one per digit
// bit, give each lane the mask of lanes that hold its digit in the round; a
// key's rank is the warp's running count of its digit plus its peers in
// lower lanes, and the lowest lane of each group advances the count. The
// counters are private to a warp and each is written by one lane a round:
// no shared-memory atomics, which would serialise on the few digits of the
// top pass (the sketch keys use 27 of 32 bits, and up to ~45% of a row is
// INT32_MAX padding). The per-warp counts are then scanned across warps and
// digits, so the keys of one digit keep the order (warp, round, lane), which
// is their order in the tile: every pass is stable and the sort exact.
//
// The passes ping-pong between the caller's scratch and out (x -> scratch ->
// out -> scratch -> out), so x is never written. The caller allocates
// everything: out and scratch (rows x N int32), hist (rows x 256 x N/T
// int32), all 16-byte aligned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kPasses = 32 / kRadixBits;
constexpr int kMaxTileLog = 12;          // tiles of at most 4096 keys
constexpr int kScanUnroll = 8;           // loads in flight per lane in scan
constexpr uint32_t kSignBit = 0x80000000u;
static_assert(kThreads == kRadix, "one thread per digit");

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

__device__ __forceinline__ uint32_t digit_of(uint32_t u, int shift) {
  return (u >> shift) & (kRadix - 1);
}

// Mask of the lanes whose digit equals this lane's.
__device__ __forceinline__ unsigned peers_of(uint32_t d) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    m &= bit ? vote : ~vote;
  }
  return m;
}

// One round of a warp's ranking: adds the round's digits (one a lane) to the
// warp's counters and returns this lane's rank among the warp's keys of its
// digit so far.
__device__ __forceinline__ int warp_rank(uint32_t d, int* cnt, unsigned lt) {
  const unsigned peers = peers_of(d);
  const int before = cnt[d];
  __syncwarp();
  if ((peers & lt) == 0u) cnt[d] = before + __popc(peers);
  __syncwarp();
  return before + __popc(peers & lt);
}

// Row and tile of this block: blocks run over rows x 2^nt_log tiles.
struct TileId {
  int64_t row;
  int tile;
};

__device__ __forceinline__ TileId tile_id(int nt_log) {
  return {int64_t(blockIdx.x >> nt_log), int(blockIdx.x & ((1u << nt_log) - 1u))};
}

// Counts the digits at `shift` of each tile of KPT * 256 keys (flipped by
// `flip`) into hist[row][digit][tile].
template <int KPT>
__global__ void __launch_bounds__(kThreads)
radix_hist(const uint32_t* __restrict__ in, int32_t* __restrict__ hist,
           int log_n, uint32_t flip, int shift) {
  constexpr int kTile = KPT * kThreads;
  constexpr int kTileLog = ilog2(kTile);
  __shared__ int cnt[kWarps][kRadix];
  const int nt_log = log_n - kTileLog;
  const TileId id = tile_id(nt_log);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[w][tid] = 0;
  // order does not matter for a count: thread-striped 16-byte loads
  const uint4* src = reinterpret_cast<const uint4*>(
      in + (id.row << log_n) + int64_t(id.tile) * kTile);
  uint32_t keys[KPT];
#pragma unroll
  for (int j = 0; j < KPT / 4; ++j) {
    const uint4 q = src[j * kThreads + tid];
    keys[4 * j + 0] = q.x ^ flip;
    keys[4 * j + 1] = q.y ^ flip;
    keys[4 * j + 2] = q.z ^ flip;
    keys[4 * j + 3] = q.w ^ flip;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KPT; ++k) warp_rank(digit_of(keys[k], shift), cnt[warp], lt);
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += cnt[w][tid];
  hist[((id.row * kRadix + tid) << nt_log) + id.tile] = total;
}

// One warp per (row, digit) segment of 2^nt_log tile counts: exclusive
// offsets in place, and the segment's total in slot 0 (tile 0's offset is
// 0 and is not stored).
__global__ void __launch_bounds__(kThreads)
radix_scan(int32_t* __restrict__ hist, int nt_log) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  int32_t* h = hist + (seg << nt_log);
  const int nt = 1 << nt_log;
  int carry = 0;
  for (int c0 = 0; c0 < nt; c0 += 32 * kScanUnroll) {
    int v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int i = c0 + u * 32 + lane;
      v[u] = i < nt ? h[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      int incl = v[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int i = c0 + u * 32 + lane;
      if (i > 0 && i < nt) h[i] = carry + incl - v[u];
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  if (lane == 0) h[0] = carry;
}

// Exclusive scan over the block's 256 threads (one value each) of a and b.
__device__ __forceinline__ void block_scan2(int& a, int& b, int (*wsum)[kWarps]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, ia, o);
    const int yb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    wsum[0][warp] = ia;
    wsum[1][warp] = ib;
  }
  __syncthreads();
  int pa = 0, pb = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      pa += wsum[0][w];
      pb += wsum[1][w];
    }
  }
  a = pa + ia - a;
  b = pb + ib - b;
}

// Moves each tile's keys (flipped by flip_in) to their place in the row by
// the digit at `shift`, stably, and writes them flipped by flip_out.
template <int KPT>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
              const int32_t* __restrict__ hist, int log_n, uint32_t flip_in,
              uint32_t flip_out, int shift) {
  constexpr int kTile = KPT * kThreads;
  constexpr int kWarpKeys = kTile / kWarps;       // 32 * KPT
  __shared__ __align__(16) uint32_t tile_keys[kTile];
  __shared__ int cnt[kWarps][kRadix];
  __shared__ int start[kRadix];   // tile position of each digit's run
  __shared__ int dest[kRadix];    // its row position, minus start
  __shared__ int wsum[2][kWarps];
  constexpr int kTileLog = ilog2(kTile);
  const int nt_log = log_n - kTileLog;
  const TileId id = tile_id(nt_log);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;

  // 1. the tile into shared memory by 16-byte loads; thread tid also takes
  //    digit tid's row total and this tile's offset from the scan
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        in + (id.row << log_n) + int64_t(id.tile) * kTile);
    uint4* s = reinterpret_cast<uint4*>(tile_keys);
#pragma unroll
    for (int j = 0; j < KPT / 4; ++j) {
      uint4 q = src[j * kThreads + tid];
      q.x ^= flip_in;
      q.y ^= flip_in;
      q.z ^= flip_in;
      q.w ^= flip_in;
      s[j * kThreads + tid] = q;
    }
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[w][tid] = 0;
  const int32_t* h = hist + ((id.row * kRadix + tid) << nt_log);
  int row_start = h[0];
  const int tile_off = id.tile == 0 ? 0 : h[id.tile];
  __syncthreads();

  // 2. each warp ranks its keys in tile order
  uint32_t keys[KPT];
  int rank[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) keys[k] = tile_keys[warp * kWarpKeys + k * 32 + lane];
#pragma unroll
  for (int k = 0; k < KPT; ++k)
    rank[k] = warp_rank(digit_of(keys[k], shift), cnt[warp], lt);
  __syncthreads();

  // 3. thread tid = digit d: its count in the warps before each warp, its
  //    run's start in the tile, and its run's start in the row
  int tile_start = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = cnt[w][tid];
    cnt[w][tid] = tile_start;
    tile_start += c;
  }
  block_scan2(tile_start, row_start, wsum);
  start[tid] = tile_start;
  dest[tid] = row_start + tile_off - tile_start;
  __syncthreads();

  // 4. the tile reordered by digit, in shared memory
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const uint32_t d = digit_of(keys[k], shift);
    tile_keys[start[d] + cnt[warp][d] + rank[k]] = keys[k];
  }
  __syncthreads();

  // 5. each run to its place in the row: tile position i goes to
  //    dest[digit] + i, so consecutive threads write consecutive addresses
  uint32_t* dst = out + (id.row << log_n);
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = j * kThreads + tid;
    const uint32_t u = tile_keys[i];
    dst[dest[digit_of(u, shift)] + i] = u ^ flip_out;
  }
}

template <int KPT>
cudaError_t radix_sort_rows(const uint32_t* x, uint32_t* out,
                            uint32_t* scratch, int32_t* hist, int64_t rows,
                            int log_n, cudaStream_t st) {
  constexpr int kTileLog = ilog2(KPT * kThreads);
  const int nt_log = log_n - kTileLog;
  const int64_t tiles = rows << nt_log;
  const int64_t segments = rows * kRadix;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const uint32_t* src = x;
  for (int pass = 0; pass < kPasses; ++pass) {
    uint32_t* dst = pass % 2 == 0 ? scratch : out;
    const uint32_t flip_in = pass == 0 ? kSignBit : 0u;
    const uint32_t flip_out = pass == kPasses - 1 ? kSignBit : 0u;
    const int shift = pass * kRadixBits;
    radix_hist<KPT><<<(unsigned)tiles, kThreads, 0, st>>>(src, hist, log_n,
                                                           flip_in, shift);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    radix_scan<<<(unsigned)(segments / kWarps), kThreads, 0, st>>>(hist, nt_log);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    radix_scatter<KPT><<<(unsigned)tiles, kThreads, 0, st>>>(
        src, dst, hist, log_n, flip_in, flip_out, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// Sorts each row of x (rows x 2^log_n int32, row-major, 10 <= log_n <= 30)
// ascending into out, through scratch (rows x 2^log_n int32) and hist
// (rows x 256 x 2^log_n / min(2^log_n, 4096) int32). x is only read.
// Launches on `stream` and returns the first launch error.
extern "C" int niqki_psort_i32(const void* x, void* out, void* scratch,
                               void* hist, int64_t rows, int log_n,
                               void* stream) {
  if (rows <= 0 || log_n < 10 || log_n > 30) return cudaErrorInvalidValue;
  const auto* in = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  auto* s = static_cast<uint32_t*>(scratch);
  auto* h = static_cast<int32_t*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log_n) {                // one tile per row below 2^kMaxTileLog
    case 10: return radix_sort_rows<4>(in, o, s, h, rows, log_n, st);
    case 11: return radix_sort_rows<8>(in, o, s, h, rows, log_n, st);
    default:
      return radix_sort_rows<(1 << kMaxTileLog) / kThreads>(in, o, s, h, rows,
                                                           log_n, st);
  }
}
