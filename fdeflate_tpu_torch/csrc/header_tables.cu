// K12 header_tables: block discovery's validated headers parsed and turned
// into K4's tables, a warp per header.
//
// Replaces no TPU kernel: the JAX package parses each validated header on
// the host (parallel/discovery.py, _parse_dynamic_lengths and
// pallas_inflate.foreign_meta), and so did the port, at ~1 ms a header in
// Python, with the card idle.  One launch takes every header of a call
// (all streams of a batch, over their concatenated words) from the stream
// words to its status, symbol start and (meta[64], tab[160]) rows, which
// stay on the card for K4; the host reads back the four int64 rows of
// `info` alone.  Block discovery launches it once a call; the sequential
// path once a round, over the streams that reached a dynamic header.
//
// Bound on the H100: the serial section decode of a header (up to 316
// code lengths, each a 7-bit table lookup after the last), a few
// microseconds, not bytes (a call reads ~200 bytes and writes 896 a
// header).  So the design spends threads on the table build, not on the
// parse: a warp takes a header (fdt::header_group, header_lanes.cuh, with
// warp.cuh's WarpGroup); its threads run the parse in step, with the
// code-length decode table and the lengths in shared memory, then rank the
// symbols of each code length by ballots and place their entries at once.
// Four headers to a block, 1472 bytes of shared memory each.
#include <cuda_runtime.h>

#include "header_lanes.cuh"
#include "warp.cuh"

namespace {

constexpr int kWarps = 4;  // headers (warps) per block

__global__ void __launch_bounds__(32 * kWarps)
header_tables_kernel(const uint32_t* __restrict__ words,
                     const int64_t* __restrict__ offs,
                     const int64_t* __restrict__ wend,
                     const int64_t* __restrict__ bit_end, int64_t W,
                     int64_t* __restrict__ info, int32_t* __restrict__ meta,
                     int32_t* __restrict__ tab, int H) {
  __shared__ fdt::HdrScratch scratch[kWarps];
  const int warp = threadIdx.x >> 5;
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (h >= H) return;
  const fdt::WarpGroup g(32, threadIdx.x & 31);
  fdt::header_group(g, words, wend[h] < W ? wend[h] : W, offs[h], bit_end[h],
                    scratch[warp], info + h, H, meta + h * fdt::kMetaRows,
                    tab + h * fdt::kTabPairs);
}

}  // namespace

// Per header h: its absolute first bit `offs[h]` into `words` (W words),
// its stream's word end `wend[h]` (words at or past it, or past W, read as
// 0) and payload end bit `bit_end[h]`.  Writes info int64[4, H] (status,
// BFINAL, symbol start, host_ok), meta int32[H, 64] and tab int32[H, 160].
extern "C" int fdt_header_tables(const void* words, const void* offs,
                                 const void* wend, const void* bit_end,
                                 int64_t W, void* info, void* meta, void* tab,
                                 int H, void* stream) {
  const int blocks = (H + kWarps - 1) / kWarps;
  header_tables_kernel<<<blocks, 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(offs),
      static_cast<const int64_t*>(wend), static_cast<const int64_t*>(bit_end),
      W, static_cast<int64_t*>(info), static_cast<int32_t*>(meta),
      static_cast<int32_t*>(tab), H);
  return static_cast<int>(cudaGetLastError());
}
