// K9 pack_v1: packed byte tokens -> lane bit windows.
//
// Replaces fdeflate_tpu/ops/pallas_pack.py:_kernel (via
// pack_blocked_pallas), the v1 pack kept on the TPU for A/B:
// win[lane, w] = OR over the lane's pairs p of (wi_p == w ? lo_p : 0) |
// (wi_p == w - 1 ? hi_p : 0).  The TPU kernel tests every pair against
// every window word because Mosaic cannot scatter; the function is
// linear, since pair p touches only words wi_p and wi_p + 1.
//
// Bound on the H100: bytes (the tokens in, the windows out).  So a warp
// takes a lane (fdt::pack_v1_group in lanes.cuh): it loads the lane's
// tokens with coalesced 16-byte loads, each thread decodes its pairs
// (fdt::pack_pair) and ORs their two words into the lane's window in
// shared memory (atomicOr; at most 257 words, since rel < 8192), and the
// warp stores the window with coalesced 16-byte stores.  Exact for any
// int32 tokens, as OR commutes.  8 warps to a block, blocks looping over
// lanes up to the grid cap.
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps)
pack_v1_kernel(const int32_t* __restrict__ tok, uint32_t* __restrict__ win,
               int64_t L, int S, int wwin) {
  __shared__ __align__(16) uint32_t buf[kWarps][fdt::kPackWords];
  const int warp = threadIdx.x >> 5;
  const fdt::WarpGroup g(32, threadIdx.x & 31);
  for (int64_t lane = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       lane < L; lane += static_cast<int64_t>(gridDim.x) * kWarps)
    fdt::pack_v1_group(g, tok, S, lane, buf[warp], win, wwin);
}

}  // namespace

// `dev`: the device the caller made current, whose stream `stream` is.
extern "C" int fdt_pack_v1(const void* tok, void* win, int L, int S, int wwin,
                           int dev, void* stream) {
  static std::atomic<int> caps[fdt::kMaxDevices];
  return static_cast<int>(fdt::launch_capped(
      pack_v1_kernel, 32 * kWarps, 0, dev, caps, L, kWarps, stream,
      static_cast<const int32_t*>(tok), static_cast<uint32_t*>(win),
      static_cast<int64_t>(L), S, wwin));
}
