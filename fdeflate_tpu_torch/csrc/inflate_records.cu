// K4 inflate_records: foreign deflate blocks -> records, one block per lane.
//
// Replaces fdeflate_tpu/ops/pallas_inflate.py:_kernel (via
// decode_records_blocked), together with the window staging before it
// (parallel/discovery._stage_windows, ops/repack.stage_windows_flat) and
// its freeze-at-window-edge resume.  Those exist because Mosaic reads a
// lane only from a VMEM window staged ahead; a CUDA thread reads its block
// straight from the flat stream words at its absolute start bit, so a
// block of any size decodes in one launch.  The TPU kernel's per-lane
// metadata rows (foreign_meta: 64 canonical bounds/kvals, 160 packed table
// pairs) are copied for the block's 32 lanes into shared memory with
// coalesced loads; the canonical compare chain then reads them per lane
// (row stride 225 words, odd, so the 32 lanes of a warp hit 32 banks).
// The lane's bit machine is fdt::inflate_lane (inflate_lanes.cuh).
//
// Records are stored step-major, recs[u * L + lane], so the lanes of a
// warp store one step's records to neighbouring words.  The caller zeroes
// recs; slots past a lane's last record stay 0 (REC_IDLE).
//
// Bound on the H100: the serial decode chain of each lane (two 32-bit
// peeks, two or three 15-compare canonical decodes per record) and its
// latency; one thread per block of the stream, so the card is filled only
// as far as the streams have blocks.
#include <cuda_runtime.h>

#include "inflate_lanes.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kRow = fdt::kMetaRows + fdt::kTabPairs + 1;

__global__ void inflate_kernel(const uint32_t* __restrict__ words,
                               const int64_t* __restrict__ start,
                               const int64_t* __restrict__ wend,
                               const int64_t* __restrict__ bit_end,
                               const int64_t* __restrict__ out0,
                               const int32_t* __restrict__ meta,
                               const int32_t* __restrict__ tab,
                               int32_t* __restrict__ recs,
                               int64_t* __restrict__ bpos,
                               int64_t* __restrict__ nout,
                               int32_t* __restrict__ done, int L, int K) {
  __shared__ int32_t rows[kThreads * kRow];
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int n = static_cast<int>(
      L - lane0 < kThreads ? L - lane0 : static_cast<int64_t>(kThreads));
  for (int i = threadIdx.x; i < n * fdt::kMetaRows; i += blockDim.x) {
    int l = i / fdt::kMetaRows, r = i % fdt::kMetaRows;
    rows[l * kRow + r] = meta[lane0 * fdt::kMetaRows + i];
  }
  for (int i = threadIdx.x; i < n * fdt::kTabPairs; i += blockDim.x) {
    int l = i / fdt::kTabPairs, r = i % fdt::kTabPairs;
    rows[l * kRow + fdt::kMetaRows + r] = tab[lane0 * fdt::kTabPairs + i];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= n) return;
  const int64_t lane = lane0 + t;
  const fdt::WordReader rd{words, wend[lane]};
  int64_t bp, no;
  done[lane] = fdt::inflate_lane(rd, start[lane], bit_end[lane], out0[lane],
                                 rows + t * kRow,
                                 rows + t * kRow + fdt::kMetaRows,
                                 recs + lane, L, K, &bp, &no);
  bpos[lane] = bp;
  nout[lane] = no;
}

}  // namespace

extern "C" int fdt_inflate_records(const void* words, const void* start,
                                   const void* wend, const void* bit_end,
                                   const void* out0, const void* meta,
                                   const void* tab, void* recs, void* bpos,
                                   void* nout, void* done, int L, int K,
                                   void* stream) {
  int blocks = (L + kThreads - 1) / kThreads;
  inflate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(wend), static_cast<const int64_t*>(bit_end),
      static_cast<const int64_t*>(out0), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(tab), static_cast<int32_t*>(recs),
      static_cast<int64_t*>(bpos), static_cast<int64_t*>(nout),
      static_cast<int32_t*>(done), L, K);
  return static_cast<int>(cudaGetLastError());
}
