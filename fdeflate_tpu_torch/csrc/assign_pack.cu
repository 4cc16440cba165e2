// K1 assign_pack: raw stream bytes -> per-lane bit windows + chunk bits.
//
// Replaces two TPU kernels: fdeflate_tpu/ops/pallas_assign.py:_kernel
// (per-lane run state machine + literal lookup -> one token per byte) and
// fdeflate_tpu/ops/pallas_pack.py:_kernel_v2 (pair-combine + OR of each
// pair into the lane window).  No token array reaches device memory: the
// tokens go straight into the window's bits.
//
// Bound on the H100: bytes (the stream in once, the windows out once:
// 16 MiB and ~27 MiB at 16 x 1 MiB, C = 512), if the card is kept busy.
// One thread per lane could not: its 2048 serial byte decisions and
// strided loads left ~2 warps on each SM and nothing to hide latency.  So
// one warp works on a lane, 8 lanes to a block (fdt::assign_pack_group in
// lanes.cuh, with the warp's operations of warp.cuh):
//   * the warp stages the lane's bytes in shared memory with coalesced
//     cp.async copies, fdt::kApTile (2048) bytes at a time;
//   * each thread classifies its own 8-byte groups (a byte's run
//     membership needs only its group and the byte before it), and a warp
//     scan of fdt::RunSeg gives every thread the run length entering its
//     segment, hence its run state and its count mod 258;
//   * pass 1 counts each segment's bits, a warp scan gives each thread its
//     bit offset, pass 2 writes the tokens into a window tile in shared
//     memory (segment edge words by shared atomicOr);
//   * the warp stores the tile's full words with coalesced 4-byte stores
//     and carries the partial word, run length and bit offset to the next
//     tile; the zeros past the payload go out the same way.
// A block holds 8 x (2048 + 4 * fdt::kApBufWords) bytes plus the token
// tables, ~44 KiB, so 5 blocks (40 warps) fit an SM.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "warp.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTables = 4 * (256 + 32);
constexpr int kWarpBytes = (fdt::kApTile + 4 * fdt::kApBufWords + 15) / 16 * 16;
constexpr int kSmem = kTables + kWarps * kWarpBytes;

__global__ void __launch_bounds__(32 * kWarps)
assign_pack_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ lit_tok_g,
                   const int32_t* __restrict__ len_tok_g,
                   uint32_t* __restrict__ win, int32_t* __restrict__ chunk_bits,
                   int B, int N, int C, int wwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* lit_tok = reinterpret_cast<int32_t*>(smem);
  int32_t* len_tok = lit_tok + 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lit_tok[i] = lit_tok_g[i];
  for (int i = threadIdx.x; i < 29; i += blockDim.x) len_tok[i] = len_tok_g[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int64_t lane_id = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (lane_id >= static_cast<int64_t>(B) * C) return;  // the whole warp
  uint8_t* tile = smem + kTables + warp * kWarpBytes;
  fdt::assign_pack_group(fdt::WarpGroup(32, threadIdx.x & 31), data, lengths,
                         N, C, lane_id, lit_tok, len_tok, tile,
                         reinterpret_cast<uint32_t*>(tile + fdt::kApTile), win,
                         wwin, chunk_bits);
}

}  // namespace

extern "C" int fdt_assign_pack(const void* data, const void* lengths,
                               const void* lit_tok, const void* len_tok,
                               void* win, void* chunk_bits,
                               int B, int N, int C, int wwin, void* stream) {
  int64_t L = static_cast<int64_t>(B) * C;
  int blocks = static_cast<int>((L + kWarps - 1) / kWarps);
  assign_pack_kernel<<<blocks, 32 * kWarps, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(lit_tok), static_cast<const int32_t*>(len_tok),
      static_cast<uint32_t*>(win),
      static_cast<int32_t*>(chunk_bits), B, N, C, wwin);
  return static_cast<int>(cudaGetLastError());
}
