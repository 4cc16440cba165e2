// K7 adler32_tiles: per-1024-byte-tile plain and weighted byte sums.
//
// Replaces fdeflate_tpu/ops/adler32_pallas.py:_tile_kernel (via
// adler32_pallas).  Tile t covers bytes [1024 t, 1024 t + 1024) of the
// buffer; bytes at or past min(n, *length) count as zero.  Outputs
// sums[t] = sum d_i and wsums[t] = sum (1024 - i) d_i over the tile's
// positions i, both below 2^31 (255 * 1024 * 1025 / 2).  The fold of the
// tiles into the checksum is plain torch in int64 (ops/adler32_pallas.py).
//
// The TPU kernel takes one (8, 128) tile per grid step in order; here one
// block of 256 threads takes one tile: each thread loads 4 neighbouring
// bytes as one 32-bit word (coalesced), then warp shuffles and one
// shared-memory step reduce both sums.  Bound on the H100: device memory
// bandwidth (one pass over the bytes); the length is read from device
// memory, so a length held on the card needs no host read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = kTile / 4;

__global__ void adler32_tiles_kernel(const uint8_t* __restrict__ data,
                                     int64_t n,
                                     const int64_t* __restrict__ length,
                                     int32_t* __restrict__ sums,
                                     int32_t* __restrict__ wsums) {
  int64_t limit = *length < n ? *length : n;
  int p = 4 * threadIdx.x;  // position of this thread's first byte in the tile
  int64_t at = static_cast<int64_t>(blockIdx.x) * kTile + p;
  uint32_t x = 0;
  if (at + 4 <= limit) {
    x = *reinterpret_cast<const uint32_t*>(data + at);  // 4-aligned buffer
  } else {
    for (int j = 0; j < 4; ++j)
      if (at + j < limit) x |= static_cast<uint32_t>(data[at + j]) << (8 * j);
  }
  int s = 0, w = 0;
  for (int j = 0; j < 4; ++j) {
    int d = (x >> (8 * j)) & 0xFF;
    s += d;
    w += d * (kTile - p - j);
  }
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, o);
    w += __shfl_down_sync(0xFFFFFFFFu, w, o);
  }
  __shared__ int ps[kThreads / 32], pw[kThreads / 32];
  int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    ps[warp] = s;
    pw[warp] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ts = 0, tw = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      ts += ps[i];
      tw += pw[i];
    }
    sums[blockIdx.x] = ts;
    wsums[blockIdx.x] = tw;
  }
}

}  // namespace

extern "C" int fdt_adler32_tiles(const void* data, int64_t n,
                                 const void* length, void* sums, void* wsums,
                                 int64_t tiles, void* stream) {
  adler32_tiles_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n,
      static_cast<const int64_t*>(length), static_cast<int32_t*>(sums),
      static_cast<int32_t*>(wsums));
  return static_cast<int>(cudaGetLastError());
}
