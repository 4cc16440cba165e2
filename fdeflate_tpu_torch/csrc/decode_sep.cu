// K6 decode_sep: fixed-geometry decode of a class-separated (septree) tree
// straight from stream words.
//
// Replaces fdeflate_tpu/ops/pallas_decode2.py:_kernel_sep (via
// decode_blocked_sep) and, as K3 does, folds in the window staging of
// ops/repack.py (_slab_kernel and the XLA shifts of
// stage_blocked_from_linear): each lane reads its stream's words from
// chunk_starts[lane] and writes S bytes (fdt::decode_sep_lane's
// semantics).
//
// Bound on the H100: bytes (the words in, S bytes per lane out), if the
// card is kept busy.  The TPU kernel's design (one lane a serial chain of
// S / 4 word steps, each sub-step an 11-compare canonical decode and a
// fetch) left ~2 warps per SM on one thread per lane.  So K6 runs K3's
// design (decode2.cu, fdt::decode2_group<kSep> in lanes.cuh): m =
// fdt::dec_threads(S) threads per lane decode sub-ranges of staged words
// speculatively, agree in sync rounds and write at scanned byte offsets,
// 32 warps to a block, blocks looping over lanes.  The sep tree becomes
// K3's 4096-entry table, built in each block's prologue from meta and
// vals (fdt::sep_entry: the bounds compares once per peek, not per
// symbol).  Where the lane's decode meets no EOB, K6's word steps are K3's
// bytes; a lane whose decode meets one (the lane holding a stream's end,
// lanes past it, corrupted lanes) is decoded again by one thread with K6's
// word steps (fdt::sep_serial, from the same table), over what its tiles
// stored, and counted in stats[4].
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

__global__ void __launch_bounds__(32 * fdt::kDecWarps, 1)
decode_sep_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ chunk_starts,
                  const int32_t* __restrict__ meta_g,
                  const int32_t* __restrict__ vals_g, uint8_t* __restrict__ out,
                  int32_t* __restrict__ bpos, unsigned long long* stats, int B,
                  int W, int N, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t meta[32];
  __shared__ int32_t vals[64];
  if (threadIdx.x < 32) meta[threadIdx.x] = meta_g[threadIdx.x];
  if (threadIdx.x < 64) vals[threadIdx.x] = vals_g[threadIdx.x];
  __syncthreads();
  int32_t* dtab = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i < (1 << fdt::kMaxL); i += blockDim.x)
    dtab[i] = fdt::sep_entry(meta, vals, i);
  __syncthreads();
  fdt::decode_lanes<true>(smem, words, W, chunk_starts, B, N, C, out, bpos,
                          stats);
}

}  // namespace

// `stats`: null, or five zeroed counters (most sync rounds of a span,
// spans, spans another span continues, sync rounds, lanes decoded
// serially).  `dev`: the device the caller made current, whose stream
// `stream` is.
extern "C" int fdt_decode_sep(const void* words, const void* chunk_starts,
                              const void* meta, const void* vals, void* out,
                              void* bpos, void* stats, int B, int W, int N,
                              int C, int dev, void* stream) {
  static std::atomic<int> caps[fdt::kMaxDevices];
  return static_cast<int>(fdt::launch_decode(
      decode_sep_kernel, dev, caps, B, N, C, stream,
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(chunk_starts),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(vals),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(bpos),
      static_cast<unsigned long long*>(stats), B, W, N, C));
}
