// K7 adler32_tiles: Adler-32 of a batch of byte rows, tile sums and fold in
// one launch.
//
// Replaces fdeflate_tpu/ops/adler32_pallas.py:_tile_kernel (via
// adler32_pallas), whose outputs are the per-1024-byte-tile plain and
// weighted sums (S_t = sum d_i, W_t = sum (1024 - i) d_i, bytes at or past
// the length counted as zero); the fold of the tiles into the checksum is
// XLA glue there.  Here one launch takes B rows (any row stride) with their
// lengths, and writes each row's checksum; the tile sums are written too
// when the caller passes buffers for them (int32[B, T], T = ceil(n /
// 1024)).  So the same kernel is adler32_pallas (B = 1) and the encode's
// per-stream adler32_batch.
//
// Bound on the H100: device memory bandwidth, one pass over the bytes.  A
// half-warp takes a tile (fdt::adler_tile_group in lanes.cuh): 16-byte
// loads of the 16-aligned chunks of the tile (a row start need not be
// aligned), all issued before any is summed, byte dot products (__dp4a)
// for both sums, a reduce.  The blocks, a few per SM, each take a
// contiguous range of the B * T tiles, their half-warps interleaved over
// it; a half-warp keeps its stream's tile terms (S_t for A, and
// ((length - o_t - 1024) mod 65521) S_t + W_t, reduced, for B) in 64-bit
// registers, flushes them to the block's shared sums when its
// stream changes, and the block adds those to the row's global sums with
// one 64-bit atomic each.  The last block to finish (a counter) turns the
// sums into the checksums and zeroes the sums and the counter for the next
// launch on the same workspace: no host sync, no second launch.
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 16;       // threads to a tile
constexpr int kGroups = 32 * kWarps / kGroup;
constexpr int kSlots = 32;       // streams of a block summed in shared memory
constexpr int kMinTiles = 32;    // tiles a block takes at least

struct Lengths {
  const void* p;  // int32[B] or int64[B]; null: every row `value` bytes
  int is64;
  int64_t value;

  __device__ int64_t operator()(int64_t b) const {
    if (!p) return value;
    return is64 ? static_cast<const int64_t*>(p)[b]
                : static_cast<const int32_t*>(p)[b];
  }
};

__global__ void __launch_bounds__(32 * kWarps)
adler32_kernel(const uint8_t* __restrict__ data, int64_t stride, int64_t B,
               int64_t n, Lengths len_of, int64_t T, int64_t per_block,
               unsigned long long* __restrict__ acc,
               int64_t* __restrict__ out, int32_t* __restrict__ sums,
               int32_t* __restrict__ wsums) {
  __shared__ unsigned long long sa[kSlots], sb[kSlots];
  __shared__ bool last;
  const int group = threadIdx.x / kGroup, lane = threadIdx.x & 31;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t t1 = t0 + per_block < B * T ? t0 + per_block : B * T;
  const int64_t b0 = T ? t0 / T : 0;
  if (threadIdx.x < kSlots) sa[threadIdx.x] = sb[threadIdx.x] = 0;
  __syncthreads();

  const fdt::WarpGroup g(kGroup, lane);
  int64_t cur = -1, length = 0, limit = 0;
  unsigned long long a = 0, bsum = 0;
  auto flush = [&]() {
    if (cur < 0 || g.i != 0) return;
    if (cur - b0 < kSlots) {
      atomicAdd(&sa[cur - b0], a);
      atomicAdd(&sb[cur - b0], bsum);
    } else {
      atomicAdd(&acc[2 * cur], a);
      atomicAdd(&acc[2 * cur + 1], bsum);
    }
  };
  for (int64_t t = t0 + group; t < t1; t += kGroups) {
    const int64_t b = t / T, o = (t - b * T) * fdt::kAdlerTile;
    if (b != cur) {
      flush();
      cur = b;
      a = bsum = 0;
      length = len_of(b);
      limit = length < n ? length : n;
    }
    const fdt::TileSums ts =
        fdt::adler_tile_group(g, data + b * stride, o, limit);
    if (sums && g.i == 0) {
      sums[t] = ts.s;
      wsums[t] = ts.w;
    }
    a += static_cast<uint32_t>(ts.s);
    bsum += fdt::adler_term(length, o, ts);
  }
  flush();
  __syncthreads();
  if (threadIdx.x < kSlots) {
    const int64_t b = b0 + threadIdx.x;
    if (b < B && (sa[threadIdx.x] | sb[threadIdx.x])) {
      atomicAdd(&acc[2 * b], sa[threadIdx.x]);
      atomicAdd(&acc[2 * b + 1], sb[threadIdx.x]);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&acc[2 * B], 1ull) == gridDim.x - 1ull;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int64_t b = threadIdx.x; b < B; b += blockDim.x) {
    const unsigned long long sa_b = atomicExch(&acc[2 * b], 0ull);
    const unsigned long long sb_b = atomicExch(&acc[2 * b + 1], 0ull);
    out[b] = fdt::adler_finish(len_of(b), sa_b, sb_b);
  }
  if (threadIdx.x == 0) atomicExch(&acc[2 * B], 0ull);
}

}  // namespace

// data: row b at data + b * stride, n bytes each; lengths: int32[B]
// (len64 0) or int64[B] (len64 1), or null for `length` bytes in every row;
// acc: uint64[2 B + 1] of zeros, left zero; out: int64[B]; sums, wsums:
// int32[B, ceil(n / 1024)] or null.  `dev`: the device the caller made
// current, whose stream `stream` is.
extern "C" int fdt_adler32_tiles(const void* data, int64_t stride, int64_t B,
                                 int64_t n, const void* lengths, int len64,
                                 int64_t length, void* acc, void* out,
                                 void* sums, void* wsums, int dev,
                                 void* stream) {
  static std::atomic<int> caps[fdt::kMaxDevices];
  const int64_t T = (n + fdt::kAdlerTile - 1) / fdt::kAdlerTile;
  const int64_t tiles = B * T;
  int cap = 0;
  cudaError_t err =
      fdt::grid_cap(adler32_kernel, 32 * kWarps, 0, dev, caps, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (tiles + kMinTiles - 1) / kMinTiles;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 0 ? blocks : 1;
  const int64_t per_block = (tiles + blocks - 1) / blocks;
  blocks = per_block ? (tiles + per_block - 1) / per_block : 1;
  adler32_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), stride, B, n,
      Lengths{lengths, len64, length}, T, per_block,
      static_cast<unsigned long long*>(acc), static_cast<int64_t*>(out),
      static_cast<int32_t*>(sums), static_cast<int32_t*>(wsums));
  return static_cast<int>(cudaGetLastError());
}
