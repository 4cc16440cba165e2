// K2 combine: lane windows -> linear stream words at each lane's bit start.
//
// Replaces fdeflate_tpu/ops/repack.py:_combine_kernel, which ORs lane rows
// into 1024-word output slabs with each lane's word shift applied in
// flight (slab-granular DMA is all Mosaic offers for per-lane placement).
// Here a warp takes a lane (fdt::combine_group in lanes.cuh, with
// warp.cuh's WarpGroup), eight lanes to a block: each thread forms four
// consecutive output words at a time from the lane's window words j-1 and
// j by a funnel shift and stores them with one 16-byte store where they are
// aligned, so a warp writes 512 contiguous bytes per step.  Each output
// word belongs to the lane its first bit lies in; that lane also ORs in
// the lanes that start inside its last word, so every word of [B, W] is
// written exactly once, plainly: no atomics, and no zero fill before the
// launch (the words before a stream's first lane are written as zeros by
// that lane; those past its last lane's payload, most of W where a stream
// compresses well, by warps of their own after the lanes', 4096 words
// each).
//
// Bound on the H100: memory traffic, the used window words read once (and
// the neighbouring word again, from L1) and the stream words written once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "warp.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps)
combine_kernel(const uint32_t* __restrict__ win,
               const int32_t* __restrict__ chunk_bits,
               const int32_t* __restrict__ pos0, uint32_t* __restrict__ words,
               int64_t L, int C, int wwin, int W, int64_t pieces) {
  const int64_t job =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const fdt::WarpGroup g(32, threadIdx.x & 31);
  if (job < L) {
    fdt::combine_group(g, win, chunk_bits, pos0, words, C, wwin, W, job);
  } else if (job - L < (L / C) * pieces) {
    const int64_t z = job - L;
    fdt::combine_zero_group(g, chunk_bits, pos0, words, C, W, z / pieces,
                            z % pieces);
  }
}

}  // namespace

extern "C" int fdt_combine(const void* win, const void* chunk_bits,
                           const void* pos0, void* words, int B, int C,
                           int wwin, int W, void* stream) {
  const int64_t L = static_cast<int64_t>(B) * C;
  const int64_t pieces = (W + fdt::kCombineZero - 1) / fdt::kCombineZero;
  const int64_t blocks = (L + B * pieces + kWarps - 1) / kWarps;
  combine_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(win), static_cast<const int32_t*>(chunk_bits),
      static_cast<const int32_t*>(pos0), static_cast<uint32_t*>(words), L, C,
      wwin, W, pieces);
  return static_cast<int>(cudaGetLastError());
}
