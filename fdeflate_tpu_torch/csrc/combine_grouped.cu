// K10 combine_grouped: lane windows -> linear stream words, a warp per
// 1024-word output slab.
//
// Replaces fdeflate_tpu/ops/repack.py:_combine_kernel_grouped (via
// linear_from_rows(group=K)): its output equals K2's (each lane's used
// window words ORed into the stream words at bit pos0[lane]).  The TPU
// kernel's grid is the output slabs, each fed the range of lanes that can
// touch it, found beforehand by a search in XLA.  Here a warp takes a slab
// (fdt::combine_slab_group in lanes.cuh) and finds that range itself: two
// 32-way searches over its stream's lanes, whose starts rise along the
// stream, a load and a ballot a round (two rounds at C = 512).  It stages
// the window words that reach the slab, up to 32 lanes at a time, with
// 16-byte cp.async copies into its shared buffer, and each thread forms
// its own output words from the staged lanes that reach them by a funnel
// shift, stored with 16-byte stores.  A slab with no lane (most of a
// stream's words where it compresses well) is a zero store.  Every word is
// written by its owner thread, with no atomics: the output needs no
// zeroing.  8 warps to a block, one slab each.
//
// Bound on the H100: memory traffic, the used window words in and the
// stream words out.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "warp.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps)
combine_grouped_kernel(const uint32_t* __restrict__ win,
                       const int32_t* __restrict__ chunk_bits,
                       const int32_t* __restrict__ pos0,
                       uint32_t* __restrict__ words, int B, int C, int wwin,
                       int W, int64_t nslabs) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t job = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (job >= B * nslabs) return;
  const fdt::WarpGroup g(32, threadIdx.x & 31);
  fdt::combine_slab_group(g, win, chunk_bits, pos0, words, C, wwin, W,
                          static_cast<int64_t>(B) * C, job / nslabs,
                          job % nslabs, smem + warp * fdt::kSlabBuf);
}

}  // namespace

extern "C" int fdt_combine_grouped(const void* win, const void* chunk_bits,
                                   const void* pos0, void* words, int B, int C,
                                   int wwin, int W, void* stream) {
  constexpr int smem = kWarps * fdt::kSlabBuf * sizeof(uint32_t);
  static_assert(smem <= 48 * 1024, "inside the default shared memory");
  const int64_t nslabs = (W + fdt::kSlabWords - 1) / fdt::kSlabWords;
  const int64_t blocks = (B * nslabs + kWarps - 1) / kWarps;
  if (blocks == 0) return cudaSuccess;
  combine_grouped_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(win),
      static_cast<const int32_t*>(chunk_bits),
      static_cast<const int32_t*>(pos0), static_cast<uint32_t*>(words), B, C,
      wwin, W, nslabs);
  return static_cast<int>(cudaGetLastError());
}
