// K4 inflate_records: foreign deflate blocks -> records, a warp per lane.
//
// Replaces fdeflate_tpu/ops/pallas_inflate.py:_kernel (via
// decode_records_blocked), together with the window staging before it
// (parallel/discovery._stage_windows, ops/repack.stage_windows_flat) and
// its freeze-at-window-edge resume.  Those exist because Mosaic reads a
// lane only from a VMEM window staged ahead; here a lane's group stages its
// block from the flat stream words span by span, so a block of any size
// decodes in one launch.
//
// Bound on the H100: the serial decode chain of a block (~16k records at
// zlib's default memLevel), one load and table lookup after another.  One
// thread per block left the card a few warps for a stream of ~100 blocks,
// each walking ~16k records bound by load latency (two global peeks and up
// to three 15-compare canonical decodes per record).  So a warp takes a
// lane and m = fdt::inf_threads(hint) of its threads decode it
// (fdt::inflate_group, inflate_lanes.cuh, with warp.cuh's WarpGroup):
//   * the warp copies the lane's foreign_meta row (64 + 160 words) into
//     shared memory and builds its decode lookup there: a 1024-entry
//     direct table for the first 10 bits of the litlen and of the distance
//     peek, the compare chain only for codes it cannot settle;
//   * the group stages 2048 words of the block at a time with cp.async
//     and splits the span among its threads, which decode speculatively
//     from evenly spaced bits and redo from their predecessor's exit until
//     every start is a record boundary of the serial decode; a write pass
//     stores each thread's records at its scanned slot (step-major,
//     recs[u * L + lane]; the caller zeroes recs).
// Two lanes to a block, 17 KiB of shared memory each.
#include <cuda_runtime.h>

#include "inflate_lanes.cuh"
#include "warp.cuh"

namespace {

constexpr int kLanes = 2;  // lanes (warps) per block
constexpr int kLaneWords = 2 * fdt::kInfTable + fdt::kMetaRows +
                           fdt::kTabPairs + fdt::kInfTileWords;

__global__ void __launch_bounds__(32 * kLanes)
inflate_kernel(const uint32_t* __restrict__ words,
               const int64_t* __restrict__ start,
               const int64_t* __restrict__ wend,
               const int64_t* __restrict__ bit_end,
               const int64_t* __restrict__ out0,
               const int32_t* __restrict__ meta,
               const int32_t* __restrict__ tab, int32_t* __restrict__ recs,
               int64_t* __restrict__ bpos, int64_t* __restrict__ nout,
               int32_t* __restrict__ done, unsigned long long* stats, int L,
               int K) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanes + warp;
  if (lane >= L) return;
  int32_t* lit = smem + warp * kLaneWords;
  int32_t* dist = lit + fdt::kInfTable;
  int32_t* meta_s = dist + fdt::kInfTable;
  int32_t* tab_s = meta_s + fdt::kMetaRows;
  uint32_t* sw = reinterpret_cast<uint32_t*>(tab_s + fdt::kTabPairs);
  for (int r = t; r < fdt::kMetaRows; r += 32)
    meta_s[r] = meta[lane * fdt::kMetaRows + r];
  for (int r = t; r < fdt::kTabPairs; r += 32)
    tab_s[r] = tab[lane * fdt::kTabPairs + r];
  __syncwarp();
  fdt::inf_table_part(meta_s, tab_s, lit, dist, t, 32);
  __syncwarp();
  const int64_t he = fdt::inf_hint_end(start, wend, bit_end, L, lane);
  const int m = fdt::inf_threads(he - start[lane]);
  if (t >= m) return;
  fdt::WarpGroup g(m, t);
  g.stats = stats;
  const fdt::InfTables tb{lit, dist, meta_s, tab_s};
  fdt::inflate_group(g, words, start[lane], wend[lane], bit_end[lane],
                     out0[lane], he, tb, sw, recs + lane, L, K, bpos + lane,
                     nout + lane, done + lane);
}

}  // namespace

// `stats`: null, or four zeroed counters of the lanes' spans (most sync
// rounds of a span, spans, spans another span continues, sync rounds).
extern "C" int fdt_inflate_records(const void* words, const void* start,
                                   const void* wend, const void* bit_end,
                                   const void* out0, const void* meta,
                                   const void* tab, void* recs, void* bpos,
                                   void* nout, void* done, void* stats, int L,
                                   int K, void* stream) {
  const int blocks = (L + kLanes - 1) / kLanes;
  const size_t smem = sizeof(int32_t) * kLanes * kLaneWords;
  inflate_kernel<<<blocks, 32 * kLanes, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(wend), static_cast<const int64_t*>(bit_end),
      static_cast<const int64_t*>(out0), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(tab), static_cast<int32_t*>(recs),
      static_cast<int64_t*>(bpos), static_cast<int64_t*>(nout),
      static_cast<int32_t*>(done), static_cast<unsigned long long*>(stats), L,
      K);
  return static_cast<int>(cudaGetLastError());
}
