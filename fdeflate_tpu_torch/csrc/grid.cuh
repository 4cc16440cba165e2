// The grid of the kernels whose blocks loop over lanes (decode2.cu,
// decode_sep.cu, decode2_canon.cu, pack_v1.cu) or take a share of the
// tiles (adler32_tiles.cu): as many blocks as are resident on the device
// at once; and the shape the three decode kernels share, K3's.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

#include "lanes.cuh"
#include "warp.cuh"

namespace fdt {

constexpr int kMaxDevices = 64;

// Blocks of `kernel` (`threads` threads and `smem` bytes of dynamic shared
// memory each) resident on device `dev` at once, into *cap; sets the
// kernel's shared-memory limit there first.  `caps` keeps the result per
// device (one array per kernel); a race recomputes the same value.
template <class Kernel>
cudaError_t grid_cap(Kernel kernel, int threads, int smem, int dev,
                     std::atomic<int>* caps, int* cap) {
  if (dev >= 0 && dev < kMaxDevices && (*cap = caps[dev].load()) > 0)
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  *cap = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices) caps[dev].store(*cap);
  return cudaSuccess;
}

// Launch `kernel(args...)` on `stream` with blocks of `threads` threads
// and `smem` bytes of dynamic shared memory: enough blocks for `items`
// lanes at `per_block` a block, at most the grid cap on device `dev` (the
// blocks loop over the rest).  Returns the launch's error.
template <class Kernel, class... Args>
cudaError_t launch_capped(Kernel kernel, int threads, int smem, int dev,
                          std::atomic<int>* caps, int64_t items,
                          int64_t per_block, void* stream, Args... args) {
  int cap = 0;
  cudaError_t err = grid_cap(kernel, threads, smem, dev, caps, &cap);
  if (err != cudaSuccess) return err;
  const int64_t need = (items + per_block - 1) / per_block;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return cudaGetLastError();
}

// K3's shape: kDecWarps warps to a block, one block to an SM; the block's
// dynamic shared memory holds the 4096-entry decode table, then each
// warp's dec_warp_bytes() of output tiles and staged words.
constexpr int kDecWarps = 32;
constexpr int kDecTable = 4 << kMaxL;
constexpr int kDecSmem = kDecTable + kDecWarps * dec_warp_bytes();

// The block's lanes of B * C (N bytes a stream, W words), m =
// dec_threads(N / C) threads to a lane, 32 / m lanes to a warp, blocks
// looping over lanes: decode2_group<kSep> with the table at the start of
// `smem`.  `stats`: null, or K3's span counters (WarpGroup::span_done).
template <bool kSep>
__device__ void decode_lanes(unsigned char* smem, const uint32_t* words,
                             int64_t W, const int32_t* chunk_starts, int B,
                             int N, int C, uint8_t* out, int32_t* bpos,
                             unsigned long long* stats) {
  const int32_t* dtab = reinterpret_cast<const int32_t*>(smem);
  const int m = dec_threads(N / C), per_warp = 32 / m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpGroup g(m, lane);
  g.stats = stats;
  uint8_t* tile = smem + kDecTable + warp * dec_warp_bytes() +
                  (lane / m) * dec_lane_bytes(m);
  uint32_t* sw = reinterpret_cast<uint32_t*>(tile + dec_tile(m));
  const int64_t L = static_cast<int64_t>(B) * C;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kDecWarps * per_warp;
  for (int64_t id =
           (static_cast<int64_t>(blockIdx.x) * kDecWarps + warp) * per_warp +
           lane / m;
       id < L; id += step) {
    decode2_group<WarpGroup, kSep>(g, words, W, chunk_starts, N, C, id, dtab,
                                   dec_tile(m), tile, sw, out, bpos);
  }
}

// Launch a decode kernel of K3's shape over B * C lanes of N / C bytes.
template <class Kernel, class... Args>
cudaError_t launch_decode(Kernel kernel, int dev, std::atomic<int>* caps,
                          int B, int N, int C, void* stream, Args... args) {
  return launch_capped(kernel, 32 * kDecWarps, kDecSmem, dev, caps,
                       static_cast<int64_t>(B) * C,
                       static_cast<int64_t>(kDecWarps) *
                           (32 / dec_threads(N / C)),
                       stream, args...);
}

}  // namespace fdt
